#!/usr/bin/env bash
# The sweeps of scripts/ that have a TPU-era record in results/, each run on
# the port with the runner and held to its record's iteration counts.
#
#     bash dealii_multigrid_tpu_torch/tools/recorded_sweeps.sh OUT_DIR COMMIT [runner options]
#
# COMMIT goes to each artifact's header ("" takes git rev-parse HEAD).
# Each sweep leaves OUT_DIR/<generator>[-args].txt and OUT_DIR/<...>.log (the
# runner's output); the last line of each log counts the rows equal to the
# record, differing, ambiguous and without a record (and, for a sweep with
# sharded rows, their partition columns equal to the record's or not).  Extra options (e.g.
# --device cpu) go to every run.  A sweep that fails or differs does not
# stop the others; the exit code is the number of such sweeps.
set -u
out=${1:?usage: recorded_sweeps.sh OUT_DIR COMMIT [runner options]}
commit=${2?usage: recorded_sweeps.sh OUT_DIR COMMIT [runner options]}
shift 2
mkdir -p "$out"
bad=0

run() {  # name, then the runner's arguments
  local name=$1
  shift
  python3 -m dealii_multigrid_tpu_torch.tools.run_experiment "$@" \
    --out "$out/$name.txt" ${commit:+--commit "$commit"} ${extra[@]+"${extra[@]}"} \
    > "$out/$name.log" 2>&1 || bad=$((bad + 1))
  tail -n 1 "$out/$name.log"
}

extra=("$@")
run small-scaling-quadrant small-scaling quadrant --max-ref 7 \
  --against results/small-scaling-quadrant-tpu-merged.txt
run parameters_hp_amg-4-5-6 parameters_hp_amg 4 5 6 \
  --against results/parameters-hp-amg-tpu.txt \
  --against results/parameters-hp-amg-trunc-tpu-merged.txt \
  --against results/parameters-hp-amg-trunc-tpu-part3.txt
run large_scaling_hp large_scaling_hp --max-ref 6 \
  --against results/large-scaling-hp-tpu.txt
run parameters_mgnumber-4-5-6 parameters_mgnumber 4 5 6 \
  --against results/parameters-mgnumber-tpu.txt \
  --against results/parameters-mgnumber-tpu-r5partial.txt
run small-scaling-hypercube small-scaling-hypercube --max-ref 6 \
  --against results/small-scaling-hypercube-tpu.txt \
  --against results/small-scaling-hypercube-tpu-r5.txt
run small-scaling-annulus small-scaling annulus --max-ref 6 \
  --against results/small-scaling-annulus-tpu-r5.txt
run small-scaling-gaussian small-scaling-gaussian --max-ref 5 \
  --against results/small-scaling-gaussian-tpu.txt
run parameters_smoother_degree-4-5-6 parameters_smoother_degree 4 5 6 \
  --against results/parameters-smoother-degree-tpu.txt
run parameters_tolerance-5-6 parameters_tolerance 5 6 \
  --against results/parameters-tolerance-tpu.txt
run parameters_weights-5-6 parameters_weights 5 6 \
  --against results/parameters-weights-tpu.txt
# NShards 8 and 1 alternate: the 8-rank rows run over 8 ranks (sharing the
# card) and their partition columns are held to the record's rows too
run large_scaling_partitioning-8-1 large_scaling_partitioning 8,1 --max-ref 5 \
  --against results/large-scaling-partitioning-virtual8.txt
exit $bad
