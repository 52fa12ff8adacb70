// The assembly exchange of the hybrid operator (ops/hybrid.py) in place on
// the level's slot vector, one launch per sweep axis, float and double.
//
// A DoF shared by several cells has one slot in each; after the bulk
// compute every slot holds its own cell's part, and the exchange leaves in
// each the sum over the DoF's slots.  Its plain version
// (ops/assembly_exchange.py, ``reference_``) is PyTorch's chain of 19 to
// 112 kernels: the irregular groups' sums from the raw values, then per
// geometric axis the face-plane sweeps of the patch bucket [NP, S, S, S],
// of the singleton bucket [NS, n1, n1, n1] and the patch<->singleton cross
// terms (each axis's adds read the values from before the axis), then the
// irregular slots overwritten with their sums.
//
// The host plan (``ExchangePlan``) lists, per axis, the groups of slots
// that the axis sums into each other; one thread takes one group point: it
// reads every member, then writes every member, so no two threads touch one
// slot, no atomics are needed, and the result is the same on every run:
//
//   patch pair     the upper face plane of patch L and the lower face
//                  plane of its upper neighbour H at one point (u, v):
//                  both become a + b;
//   singleton pair the same on the singleton bucket;
//   cross star     a patch face point P and the up to four singleton
//                  sub-block points the 0/1 overlap assembly (Easm) maps
//                  onto it: P + Z with Z the einsum's two stages, first
//                  over the face's first axis, then its second (each a sum
//                  of at most two nonzero terms, so one rounding each),
//                  and each singleton point s + P;
//   irregular      every slot of a DoF the sweeps do not complete (axis 0's
//                  launch only): the sum of the raw values in the order
//                  PyTorch's CUDA reduction of ``r[slots].sum(-1)`` takes,
//                  written to every slot of the group.
//
// Each member's new value rounds as the eager chain's does: its own value
// plus the others' contribution, every operation rounded to nearest on its
// own (__fadd_rn, __dadd_rn).  Where a member has no partner on a face the
// chain adds an exact zero (a value times a 0 mask); the kernel leaves the
// slot as it is, which differs at most in the sign of a zero.
//
// The irregular groups ride in axis 0's launch: their slots belong to DoFs
// no sweep completes, and a sweep group holds slots of one DoF only, so the
// sweeps skip every group whose slots are irregular (a bit per slot) and
// never read or write a slot the irregular threads own.  The sums are
// taken from the raw values and written at once, without a buffer: three
// launches an exchange, none where an axis has no group.
//
// It replaces no TPU kernel: the JAX package leaves the exchange to XLA
// (dealii_multigrid_tpu/ops/hybrid.py:2248-2314).  Bound by bytes: each
// group member is read once and written once per axis it takes part in
// (``ExchangePlan.bytes``); a plane along the patch's last axis is read at
// a stride of S values, one 32-byte sector a value.
//
// Launches go on the caller's stream, allocate nothing and never
// synchronise, so a CUDA graph captures them; each entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
// PyTorch's block width for a reduction over a contiguous dimension of n
// values stops at a warp; the plan refuses groups of 64 slots or more,
// where the reduction would also cross warps.
constexpr int kWarp = 32;

bool g_ready[kMaxDevices];

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

struct Plan {
  const int32_t* pp;        // [n_pp, 2]: lower patch, upper patch
  const int32_t* ss;        // [n_ss, 2]: lower singleton, upper singleton
  const int32_t* xf;        // [n_xf, 2 + K*K]: patch, side, singleton per block (-1: none)
  const int32_t* irr_off;   // [n_irr + 1]: each group's first entry in irr_slots
  const int32_t* irr_slots; // the groups' slots
  const uint32_t* irr_bits; // bit s: slot s is irregular (null: no group)
  int64_t n_pp, n_ss, n_xf, n_irr;
  int64_t patch_slots;      // NP * S^3: the first singleton slot
  int S, n1, K, nloc;
  int axis;                 // geometric axis of the patch sweep and cross terms (0 x, 1 y, 2 z)
  int saxis;                // geometric axis of the singleton sweep
};

// a patch's slot of lattice point (x, y, z): [NP, x, y, z], z fastest
__device__ __forceinline__ int64_t patch_point(const Plan& p, int axis, int pos, int u, int v) {
  const int S = p.S;
  if (axis == 0) return static_cast<int64_t>(pos) * S * S + u * S + v;
  if (axis == 1) return static_cast<int64_t>(u) * S * S + pos * S + v;
  return static_cast<int64_t>(u) * S * S + v * S + pos;
}

// a singleton's local slot of (x, y, z): [NS, z, y, x], x fastest; (u, v)
// the plane's other two axes in increasing order
__device__ __forceinline__ int single_point(const Plan& p, int axis, int pos, int u, int v) {
  const int n = p.n1;
  if (axis == 0) return (v * n + u) * n + pos;  // x = pos, y = u, z = v
  if (axis == 1) return (v * n + pos) * n + u;  // x = u, y = pos, z = v
  return (pos * n + v) * n + u;                 // x = u, y = v, z = pos
}

__device__ __forceinline__ bool irregular(const Plan& p, int64_t slot) {
  return p.irr_bits != nullptr && ((p.irr_bits[slot >> 5] >> (slot & 31)) & 1u);
}

template <typename T>
__device__ __forceinline__ void pair(T* r, int64_t a, int64_t b) {
  const T va = r[a], vb = r[b];
  r[a] = add(va, vb);
  r[b] = add(vb, va);
}

// the sub-blocks of a patch face that hold face coordinate s: (block, local)
__device__ __forceinline__ int blocks_of(const Plan& p, int s, int* blk, int* loc) {
  const int deg = p.n1 - 1;
  if (s == 0) {
    blk[0] = 0; loc[0] = 0;
    return 1;
  }
  if (s == p.S - 1) {
    blk[0] = p.K - 1; loc[0] = deg;
    return 1;
  }
  if (s % deg == 0) {
    blk[0] = s / deg - 1; loc[0] = deg;
    blk[1] = s / deg; loc[1] = 0;
    return 2;
  }
  blk[0] = s / deg; loc[0] = s % deg;
  return 1;
}

template <typename T>
__device__ void cross_star(T* r, const Plan& p, int64_t f, int s, int t) {
  const int32_t* row = p.xf + f * (2 + p.K * p.K);
  const int64_t base = static_cast<int64_t>(row[0]) * p.S * p.S * p.S;
  const int side = row[1];
  const int64_t ps = base + patch_point(p, p.axis, side ? p.S - 1 : 0, s, t);
  if (irregular(p, ps)) return;
  int ub[2], ul[2], vb[2], vl[2];
  const int nu = blocks_of(p, s, ub, ul), nv = blocks_of(p, t, vb, vl);
  // the singletons sit below a lower face (their upper plane) or above an
  // upper one (their lower plane)
  const int spos = side ? 0 : p.n1 - 1;
  int64_t ms[4];
  T mv[4];
  int nm = 0;
  T z = T(0);
  for (int j = 0; j < nv; ++j) {
    T col = T(0);
    for (int i = 0; i < nu; ++i) {
      const int sg = row[2 + ub[i] * p.K + vb[j]];
      if (sg < 0) continue;
      const int64_t slot = p.patch_slots + static_cast<int64_t>(sg) * p.nloc +
                           single_point(p, p.axis, spos, ul[i], vl[j]);
      ms[nm] = slot;
      mv[nm] = r[slot];
      col = add(col, mv[nm]);
      ++nm;
    }
    z = add(z, col);
  }
  if (nm == 0) return;
  const T vp = r[ps];
  r[ps] = add(vp, z);
  for (int k = 0; k < nm; ++k) r[ms[k]] = add(mv[k], vp);
}

// PyTorch's CUDA sum of n contiguous values (n < 64): block width w, the
// largest power of two <= n; thread t of the width accumulates values t,
// t + w, ... into four partial sums by turn (from zero) and adds them in
// order; the threads' sums meet in a warp tree of decreasing offsets.
template <typename T>
__device__ T torch_sum(const T* r, const int32_t* slots, int n) {
  int w = 1;
  while (2 * w <= n) w *= 2;
  T part[kWarp];
  for (int t = 0; t < w; ++t) {
    T acc[4] = {T(0), T(0), T(0), T(0)};
    int j = 0;
    for (int i = t; i < n; i += w, ++j) acc[j & 3] = add(acc[j & 3], r[slots[i]]);
    part[t] = add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
  }
  for (int off = w >> 1; off > 0; off >>= 1)
    for (int t = 0; t < off; ++t) part[t] = add(part[t], part[t + off]);
  return part[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) assembly_exchange_axis(T* r, Plan p) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int SS = p.S * p.S;
  const int64_t n_pp = p.n_pp * SS;
  if (i < n_pp) {
    const int64_t k = i / SS;
    const int q = static_cast<int>(i - k * SS);
    const int u = q / p.S, v = q - (q / p.S) * p.S;
    const int64_t cube = static_cast<int64_t>(SS) * p.S;
    const int64_t a = p.pp[2 * k] * cube + patch_point(p, p.axis, p.S - 1, u, v);
    if (irregular(p, a)) return;
    pair(r, a, p.pp[2 * k + 1] * cube + patch_point(p, p.axis, 0, u, v));
    return;
  }
  i -= n_pp;
  const int nn = p.n1 * p.n1;
  const int64_t n_ss = p.n_ss * nn;
  if (i < n_ss) {
    const int64_t k = i / nn;
    const int q = static_cast<int>(i - k * nn);
    const int v = q / p.n1, u = q - (q / p.n1) * p.n1;
    const int64_t a = p.patch_slots + static_cast<int64_t>(p.ss[2 * k]) * p.nloc +
                      single_point(p, p.saxis, p.n1 - 1, u, v);
    if (irregular(p, a)) return;
    pair(r, a, p.patch_slots + static_cast<int64_t>(p.ss[2 * k + 1]) * p.nloc +
                   single_point(p, p.saxis, 0, u, v));
    return;
  }
  i -= n_ss;
  const int64_t n_xf = p.n_xf * SS;
  if (i < n_xf) {
    const int64_t f = i / SS;
    const int q = static_cast<int>(i - f * SS);
    cross_star(r, p, f, q / p.S, q - (q / p.S) * p.S);
    return;
  }
  i -= n_xf;
  if (i < p.n_irr) {
    const int beg = p.irr_off[i], n = p.irr_off[i + 1] - beg;
    const T sum = torch_sum(r, p.irr_slots + beg, n);
    for (int k = 0; k < n; ++k) r[p.irr_slots[beg + k]] = sum;
  }
}

template <typename T>
int launch(void* r, const Plan& p, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices || !g_ready[device])
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = (p.n_pp + p.n_xf) * p.S * p.S + p.n_ss * p.n1 * p.n1 + p.n_irr;
  if (n == 0) return 0;
  // this library carries its own CUDA runtime: point it at the tensor's card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  assembly_exchange_axis<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(static_cast<T*>(r), p);
  return static_cast<int>(cudaGetLastError());
}

Plan make_plan(const void* pp, long long n_pp, const void* ss, long long n_ss, const void* xf,
               long long n_xf, const void* irr_off, const void* irr_slots, long long n_irr,
               const void* irr_bits, int S, int n1, int K, int nloc, long long patch_slots,
               int axis, int saxis) {
  Plan p;
  p.pp = static_cast<const int32_t*>(pp);
  p.ss = static_cast<const int32_t*>(ss);
  p.xf = static_cast<const int32_t*>(xf);
  p.irr_off = static_cast<const int32_t*>(irr_off);
  p.irr_slots = static_cast<const int32_t*>(irr_slots);
  p.irr_bits = static_cast<const uint32_t*>(irr_bits);
  p.n_pp = n_pp;
  p.n_ss = n_ss;
  p.n_xf = n_xf;
  p.n_irr = n_irr;
  p.patch_slots = patch_slots;
  p.S = S;
  p.n1 = n1;
  p.K = K;
  p.nloc = nloc;
  p.axis = axis;
  p.saxis = saxis;
  return p;
}

}  // namespace

extern "C" {

// Once per card, before its first launch.
int assembly_exchange_init(int device) {
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  g_ready[device] = true;
  return 0;
}

// One axis of the exchange on the slot vector r, in place.
#define ASSEMBLY_EXCHANGE_ENTRY(NAME, T)                                                     \
  int NAME(void* r, const void* pp, long long n_pp, const void* ss, long long n_ss,         \
           const void* xf, long long n_xf, const void* irr_off, const void* irr_slots,      \
           long long n_irr, const void* irr_bits, int S, int n1, int K, int nloc,           \
           long long patch_slots, int axis, int saxis, int device, void* stream) {          \
    return launch<T>(r, make_plan(pp, n_pp, ss, n_ss, xf, n_xf, irr_off, irr_slots, n_irr,  \
                                  irr_bits, S, n1, K, nloc, patch_slots, axis, saxis),      \
                     device, stream);                                                       \
  }

ASSEMBLY_EXCHANGE_ENTRY(assembly_exchange_f32, float)
ASSEMBLY_EXCHANGE_ENTRY(assembly_exchange_f64, double)

const char* assembly_exchange_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
