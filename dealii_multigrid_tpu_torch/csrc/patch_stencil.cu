// Sum-factorized patch Laplacian on Hopper (sm_90a), float, double and
// bfloat16: one fused pass over device memory that contracts only inside the
// band.
//
// Replaces the TPU kernel dealii_multigrid_tpu/ops/pallas_stencil.py
// (_kernel / patch_stencil_pallas, pl.pallas_call at :71).  Per patch p of
// the [NP, S, S, S] lattice bucket (axes x, y, z; z fastest):
//
//   out[p] = pscale[p] * (KS_x MS_y MS_z + MS_x KS_y MS_z + MS_x MS_y KS_z) u[p]
//
// where KS, MS are the assembled 1D patch stiffness and mass matrices
// [S, S], zero outside the half-width `band` (= p for degree p), and A_a
// contracts lattice axis a: (A_a u)[.., i, ..] = sum_j A[i, j] u[.., j, ..].
// Factored per x-plane as
//
//   AM = MS_z u,  AK = KS_z u,  C = MS_y AM,  D = KS_y AM + MS_y AK,
//   out = pscale (KS_x C + MS_x D)
//
// it costs 7 banded axis contractions, 7 (2 band + 1) FMAs per lattice point.
//
// Bound on the card.  Device traffic is one read of u and one write of out:
// 2 NP S^3 values, 73.6 MB in bf16, 147.2 MB in f32 and 294.4 MB in f64 at
// NP = 512, S = 33, i.e. 22.0 us, 43.9 us and 87.9 us at 3.35 TB/s.  The
// band work at p = 4 is about 1.5 GFLOP (22 us of FP32 FMA at 67 TFLOP/s),
// so the f32 and f64 kernels are bound by device memory and the bf16 one by
// FP32 FMA and bytes alike.  All three run at several times that bound, held
// by instruction issue and latency: the 63 band FMAs of a point come with
// shared-memory loads, copies and index arithmetic (PERF.md has the
// measurements).  What each design choice does about that:
//
//  * Band, passed from set-up.  The kernel is a template on `band` (1..8);
//    every contraction does only the 2 band + 1 products of a row.  The
//    wrapper never inspects KS or MS on the device (that would synchronise).
//  * One pass.  One block streams a patch, or an x-slab of one, plane by
//    plane along x.  Per plane it does the z contraction (AM, AK into shared
//    memory) and the y contraction (C, D, straight into registers of the
//    thread that owns the (y, z) point).  The x contraction scatters C and D
//    into a ring of 2 band + 1 partial out planes held in registers; a plane
//    of out is written once, scaled by pscale, when its last contribution
//    has arrived.  C and D never reach device memory.
//  * Few shared-memory loads per FMA.  A thread owns R neighbouring rows of
//    one z column for the whole slab (R = 3; R = 1 where S^2 <= 384, so that
//    a small plane still gives a block several warps), so each AM / AK value
//    it loads feeds up to R outputs.  Its y coefficients stay in registers
//    for the whole slab where they fit 27 words (float at R = 3 up to band
//    4); the x coefficients of a plane are one broadcast per (KS, MS) pair.
//    The same thread does the z contraction of the next plane's z chunk
//    with the same R matrix rows, so each coefficient pair serves both.  The
//    u tile and AM / AK use pitches chosen on the host so that a warp's
//    lanes hit distinct banks.  The plane loop is unrolled 3 times, so the
//    ring shifts by register renaming in two planes of every three.
//  * Loads that keep HBM busy.  u planes stream through a ring of kStages
//    shared-memory slots with cp.async, kStages - 1 planes ahead (~30 KB in
//    flight per block).  Patch and plane bases are only 4-byte (f32) or
//    8-byte (f64) aligned (S^2 and S^3 are odd), so 16-byte vectors and TMA
//    do not apply to the slot layout; element-wide cp.async with neighbouring
//    threads on neighbouring addresses still coalesces to full sectors.
//  * Fill the card at every level.  The grid runs over (patch, y-tile,
//    x-slab).  A slab recomputes `band` halo planes of C and D at its edges;
//    the host picks the slab count that minimises waves x planes per block
//    for the card's resident-block count, so NP = 64 or 8 patches still
//    cover the SMs.  y-tiles (with a `band`-row halo in the z phase) keep a
//    block within 384 threads when S > 33.
//  * Host cost.  The shared-memory opt-in and the SM count are set once per
//    card (patch_stencil_init); occupancy is cached per S; the wrapper
//    allocates only out.
//
//  * bfloat16.  The storage type G (u, KS, MS, pscale and out in device
//    memory) is separate from the compute type T = float: every contraction
//    is the float32 kernel's, FMA for FMA in the same order, and out rounds
//    to bfloat16 once, to nearest, at the store.  So the bf16 instance gives
//    bit for bit the f32 instance's result on the same values widened to
//    float32, rounded once.  Its u tiles stay bfloat16 in the ring (half
//    the bytes of a float32 tile), kHalfStages slots deep, filled by
//    cp.async; the z contraction converts each value as it reads it
//    (converting each landed value once, into float32 tiles one plane step
//    ahead, costs a shared store and load per value and was slower:
//    PERF.md).  A bfloat16 plane row is only 2-byte aligned (S^2 and S^3
//    are odd) and cp.async copies at least 4 bytes from an address aligned
//    to them, so each row is copied as the S / 2 + 1 aligned 4-byte words
//    that cover it, into a tile row placed where each value keeps its
//    device address's parity; a word that would reach past the row's end
//    takes only the row's bytes and is zero-filled.  No copy reads outside
//    the tensor's allocation: the only value read outside a row is the one
//    before an odd-aligned row, which shares its aligned 4-byte word with
//    the row's first value (allocations are at least 4-byte aligned); it
//    lands in the pad before the row, which is cleared once the plane has
//    landed, so the pads stay zero.
//
// Plain FP32/FP64 FMA throughout; no TF32, no tensor cores (a bfloat16
// design with the z and y contractions on the tensor cores, each product
// kept exact by a three-term split, ran no faster: PERF.md says why).
// Launches go on the caller's stream and never synchronise; each entry
// point returns cudaGetLastError() so a refused launch is reported to the
// wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 384;  // computing threads of a block (one y-tile of a plane)
// outputs a thread computes along y (and z): R = 1 where a block can give
// every point of a plane its own thread (S^2 <= kMaxThreads), else kRowsLarge
constexpr int kRowsLarge = 3;
constexpr int kMaxBand = 8;
constexpr int kMaxDevices = 64;

// device-memory type G -> compute type: bfloat16 computes in float32
template <typename G>
struct Compute {
  using T = G;
};
template <>
struct Compute<__nv_bfloat16> {
  using T = float;
};

__device__ __forceinline__ float to_compute(float v) { return v; }
__device__ __forceinline__ double to_compute(double v) { return v; }
__device__ __forceinline__ float to_compute(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* d, float v) { *d = v; }
__device__ __forceinline__ void store(double* d, double v) { *d = v; }
__device__ __forceinline__ void store(__nv_bfloat16* d, float v) { *d = __float2bfloat16_rn(v); }

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  using T2 = float2;
  static constexpr int kStages = 8;  // u planes in the cp.async ring
};
template <>
struct Traits<double> {
  using T2 = double2;
  static constexpr int kStages = 4;
};
// bfloat16 u tiles in the cp.async ring (even: a slot's parity shift is
// then the same for every plane it holds)
constexpr int kHalfStages = 8;

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(N)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 4 bytes of which the first src_bytes (0, 2 or 4) come from src, the rest zero
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// AM and AK are stored transposed, [z][local row y - (y0 - B)] with pitch P,
// so a thread's y window is contiguous and its loads take immediate offsets.

// z contraction of one u tile into AM, AK (am, ak point at local row zr0 -
// (y0 - B)).  The tile holds rows of S values at column offset B in rows of
// pitch SP, with zero pad columns, so src[r SP + c R + j] is window value j
// of item (r, c) and no load needs a bounds check; chunk columns past S give
// values that are never read.  Item q = (row r, chunk c of R z outputs), r
// fastest: a warp's lanes read one or two coefficient rows (broadcast), and
// the host picks SP so that their window rows fall in distinct banks.
template <typename T, typename U, int B, int R>
__device__ __forceinline__ void z_phase(const U* __restrict__ src, T* __restrict__ am,
                                        T* __restrict__ ak,
                                        const typename Traits<T>::T2* __restrict__ bc,
                                        int S, int SP, int P, int nrows, int items) {
  using T2 = typename Traits<T>::T2;
  constexpr int W = 2 * B + 1;
  constexpr int kWin = R + 2 * B;
  for (int q = threadIdx.x; q < items; q += blockDim.x) {
    const int c = q / nrows;
    const int r = q - c * nrows;
    const U* s0 = src + r * SP + c * R;
    T w[kWin];
#pragma unroll
    for (int j = 0; j < kWin; ++j) w[j] = to_compute(s0[j]);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      // rows past S give values that are never read
      const T2* row = bc + min(c * R + i, S - 1) * W;
      T sm = T(0), sk = T(0);
#pragma unroll
      for (int d = 0; d < W; ++d) {
        const T2 cf = row[d];
        sm = fma(cf.x, w[i + d], sm);
        sk = fma(cf.y, w[i + d], sk);
      }
      am[(c * R + i) * P + r] = sm;
      ak[(c * R + i) * P + r] = sk;
    }
  }
}

// y contraction at one thread's R rows of column zc (C, D), from the AM /
// AK window of rows yb - B .. yb + R - 1 + B at amn, akn.  With kZ it also
// does the z contraction of the z item whose chunk has the same R matrix
// rows (u window at urow, results to amw, akw, P apart), so each
// coefficient pair is fetched once for both.
template <typename T, typename U, int B, int R, bool kYRegs, bool kZ>
__device__ __forceinline__ void yz_columns(const T* __restrict__ amn, const T* __restrict__ akn,
                                           const typename Traits<T>::T2* __restrict__ bc,
                                           int S, int yb, const T (&ycm)[R][2 * B + 1],
                                           const T (&yck)[R][2 * B + 1], T (&C)[R],
                                           T (&D)[R], const U* __restrict__ urow,
                                           T* __restrict__ amw, T* __restrict__ akw, int P) {
  using T2 = typename Traits<T>::T2;
  constexpr int W = 2 * B + 1;
  T sm[R], sk[R];
#pragma unroll
  for (int i = 0; i < R; ++i) C[i] = D[i] = sm[i] = sk[i] = T(0);
#pragma unroll
  for (int j = 0; j < R + 2 * B; ++j) {
    const T a = amn[j];
    const T k = akn[j];
    const T w = kZ ? to_compute(urow[j]) : T(0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int d = j - i;
      if (d >= 0 && d < W) {
        T cm, ck;
        if constexpr (kYRegs) {
          cm = ycm[i][d];
          ck = yck[i][d];
        } else {
          // rows past S give values that are never stored
          const T2 v = bc[min(yb + i, S - 1) * W + d];
          cm = v.x;
          ck = v.y;
        }
        C[i] = fma(cm, a, C[i]);
        D[i] = fma(ck, a, D[i]);
        D[i] = fma(cm, k, D[i]);
        if constexpr (kZ) {
          sm[i] = fma(cm, w, sm[i]);
          sk[i] = fma(ck, w, sk[i]);
        }
      }
    }
  }
  if constexpr (kZ) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      amw[i * P] = sm[i];
      akw[i * P] = sk[i];
    }
  }
}

// The ring: acc[i][d] holds partial out plane x - B + d at row yb + i, x the
// current input plane.  With kScatter, C and D of plane x go into all of
// it; then out plane x - B, complete, is stored from acc[.][0] when `store`,
// and the ring shifts by one plane.
template <typename T, typename G, int B, int R, bool kScatter>
__device__ __forceinline__ void x_step(T (&acc)[R][2 * B + 1], const T (&C)[R],
                                       const T (&D)[R],
                                       const typename Traits<T>::T2* __restrict__ xcol,
                                       bool complete, G* __restrict__ dst, int S, int nvalid,
                                       T scale) {
  constexpr int W = 2 * B + 1;
  if constexpr (kScatter) {
#pragma unroll
    for (int d = 0; d < W; ++d) {
      const auto v = xcol[d];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i][d] = fma(v.y, D[i], fma(v.x, C[i], acc[i][d]));
    }
  }
  if (complete) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < nvalid) store(dst + i * S, scale * acc[i][0]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int d = 0; d + 1 < W; ++d) acc[i][d] = acc[i][d + 1];
    acc[i][W - 1] = T(0);
  }
}

// Shared-memory geometry of one block, the same on host and device.
struct Geometry {
  int S, H, nty, nslab;
  int ncz;        // R-wide z chunks (= R-row y chunks) of a plane
  int P;          // pitch of AM / AK (transposed: [z][local y])
  int SP;         // row pitch of u tiles
  int tile_rows;  // rows of a u tile
  int am_rows;    // local rows y - (y0 - B) of AM / AK
  int pitch_u, pitch_a;  // elements per u tile, per AM / AK buffer
};

template <typename G, int B, int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fused_stencil(const G* __restrict__ u, const G* __restrict__ KS,
                  const G* __restrict__ MS, const G* __restrict__ pscale,
                  G* __restrict__ out, const Geometry geo) {
  using T = typename Compute<G>::T;
  using T2 = typename Traits<T>::T2;
  // bfloat16: u tiles stay bfloat16, copied as aligned 4-byte words
  constexpr bool kHalf = sizeof(G) == 2;
  constexpr int W = 2 * B + 1;
  constexpr int kStages = kHalf ? kHalfStages : Traits<T>::kStages;
  // a thread's y coefficients live in registers for the whole slab where
  // they take at most 27 words (float at R = 3 up to band 4); else they are
  // re-read per plane
  constexpr bool kYRegs = sizeof(T) * R * W <= 108;
  const int S = geo.S, SP = geo.SP, P = geo.P;

  int bid = blockIdx.x;
  const int slab = bid % geo.nslab;
  bid /= geo.nslab;
  const int ty = bid % geo.nty;
  const int p = bid / geo.nty;
  // output planes [x0, x1) of this slab, input planes [xi0, xi1) with halo
  const int x0 = slab * S / geo.nslab, x1 = (slab + 1) * S / geo.nslab;
  const int xi0 = max(0, x0 - B), xi1 = min(S, x1 + B);
  const int nplanes = xi1 - xi0;
  // output rows [y0, y1) of this y-tile, z-phase rows [zr0, zr1) with halo
  const int y0 = ty * geo.H, y1 = min(S, y0 + geo.H);
  const int zr0 = max(0, y0 - B), zr1 = min(S, y1 + B);
  const int nzr = zr1 - zr0;
  const int items = geo.ncz * nzr;
  // one y-tile: thread (zc, cy) also owns z item (row zc, chunk cy)
  const bool fused = geo.nty == 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T2* bc = reinterpret_cast<T2*>(smem_raw);   // [S][W]: (MS, KS)[r][r - B + d]
  T2* xc = bc + S * W;                         // [S][W]: (KS, MS)[x - B + d][x]
  G* ring = reinterpret_cast<G*>(xc + S * W);                 // [kStages][pitch_u] u tiles
  T* am = reinterpret_cast<T*>(ring + kStages * geo.pitch_u);  // [2][pitch_a]
  T* ak = am + 2 * geo.pitch_a;                                // [2][pitch_a]
  // local AM / AK row of y = zr0
  const int am_row0 = zr0 - y0 + B;

  // zero pads and halo rows once; cp.async and the z phase then write only
  // the rows and columns that hold data
  {
    const int n4 = kHalf ? (kStages * geo.pitch_u * sizeof(G) + 4 * geo.pitch_a * sizeof(T)) / 16
                         : (kStages * geo.pitch_u + 4 * geo.pitch_a) * sizeof(T) / 16;
    float4* z4 = reinterpret_cast<float4*>(ring);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) z4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x; i < S * W; i += blockDim.x) {
    const int r = i / W;
    const int c = r - B + (i - r * W);
    const bool in = c >= 0 && c < S;
    bc[i] = in ? T2{to_compute(MS[r * S + c]), to_compute(KS[r * S + c])} : T2{T(0), T(0)};
    xc[i] = in ? T2{to_compute(KS[c * S + r]), to_compute(MS[c * S + r])} : T2{T(0), T(0)};
  }
  __syncthreads();

  // this thread's points: column zc, rows yb .. yb + nvalid - 1
  const int zc = threadIdx.x % S;
  const int cy = threadIdx.x / S;
  const int yb = y0 + cy * R;
  const int nvalid = y1 - yb;
  const size_t SS = static_cast<size_t>(S) * S;
  // a u tile holds rows [zr0, zr1) of an x-plane, each at column offset B of
  // a row of SP values whose pads stay zero; this thread copies column zc of
  // rows cy, cy + nch, ... (neighbouring threads, neighbouring addresses)
  const int nch = blockDim.x / S;
  const G* usrc = u + static_cast<size_t>(p) * SS * S + static_cast<size_t>(zr0) * S + zc;
  // bfloat16: plane n's tile starts shift(n) values into its slot, so that
  // each value keeps its device address's parity (SP has the parity of S);
  // with kStages even a slot's shift never changes.  Row r is copied as the
  // words k = 0 .. S / 2 of values 2 k - (its parity) and the next.
  // (float32 and float64 fold all of this to constants)
  const int sh0 = kHalf ? static_cast<int>(((reinterpret_cast<uintptr_t>(
                              usrc - zc + static_cast<size_t>(xi0) * SS) >> 1) + B) & 1)
                        : 0;
  auto shift = [&](int n) { return kHalf ? sh0 ^ (n & static_cast<int>(SS) & 1) : 0; };
  auto tile = [&](int n) { return ring + (n % kStages) * geo.pitch_u + shift(n); };
  const int nw = kHalf ? S / 2 + 1 : 1;
  // this thread's first (row, word) of a plane's nzr x nw words, and its
  // stride through them
  const int w_r0 = kHalf ? threadIdx.x / nw : 0, w_k0 = kHalf ? threadIdx.x % nw : 0;
  const int w_dr = kHalf ? blockDim.x / nw : 0, w_dk = kHalf ? blockDim.x % nw : 0;
  auto load_plane = [&](int n) {
    if constexpr (kHalf) {
      const G* src = usrc - zc + static_cast<size_t>(xi0 + n) * SS;
      G* dst = tile(n) + B;
      for (int r = w_r0, k = w_k0; r < nzr;) {
        const G* row = src + r * S;
        const int e = 2 * k - static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 1) & 1);
        if (e < S) cp_async4_zfill(dst + r * SP + e, row + e, 2 * min(2, S - e));
        r += w_dr;
        k += w_dk;
        if (k >= nw) k -= nw, ++r;
      }
    } else {
      const G* src = usrc + static_cast<size_t>(xi0 + n) * SS;
      T* dst = tile(n) + B + zc;
      for (int r = cy; r < nzr; r += nch) cp_async<sizeof(T)>(dst + r * SP, src + r * S);
    }
  };
  // bfloat16: zero the pad value before each row of plane n, where the word
  // of an odd-aligned row put the value before it (after a barrier that
  // follows every thread's wait for the plane)
  auto clear_heads = [&](int n) {
    unsigned short* dst = reinterpret_cast<unsigned short*>(tile(n) + B - 1);
    for (int r = threadIdx.x; r < nzr; r += blockDim.x) dst[r * SP] = 0;
  };

#pragma unroll 1
  for (int n = 0; n < kStages - 1; ++n) {
    if (n < nplanes) load_plane(n);
    cp_async_commit();
  }

  T ycm[R][W] = {}, yck[R][W] = {};
  if constexpr (kYRegs) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int d = 0; d < W; ++d) {
        const T2 v = yb + i < S ? bc[(yb + i) * W + d] : T2{T(0), T(0)};
        ycm[i][d] = v.x;
        yck[i][d] = v.y;
      }
    }
  }
  T acc[R][W];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int d = 0; d < W; ++d) acc[i][d] = T(0);
  }
  const T scale = to_compute(pscale[p]);
  G* obase = out + static_cast<size_t>(p) * SS * S + static_cast<size_t>(yb) * S + zc;
  // this thread's y window in AM / AK, and its fused z item's slots
  const int yoff = zc * P + cy * R;
  const int zoff_u = zc * SP + cy * R;
  const int zoff_a = cy * R * P + am_row0 + zc;

  if constexpr (kHalf) {
    cp_async_wait<kStages - 3>();
    __syncthreads();  // planes 0 and 1 have landed
    clear_heads(0);
    clear_heads(1);
  } else {
    cp_async_wait<kStages - 2>();
  }
  __syncthreads();  // plane 0 is in shared memory
  z_phase<T, G, B, R>(tile(0), am + am_row0, ak + am_row0, bc, S, SP, P, nzr, items);

  // unrolled, the ring shifts by register renaming in two planes of every three
#pragma unroll 3
  for (int n = 0; n < nplanes; ++n) {
    // bfloat16 waits one plane further ahead: plane n + 2 is cleared here
    cp_async_wait<kStages - 3 - kHalf>();
    __syncthreads();  // AM/AK of plane n and u of plane n + 1 are visible
    if constexpr (kHalf) {
      if (n + 2 < nplanes) clear_heads(n + 2);
    }
    if (n + kStages - 1 < nplanes) load_plane(n + kStages - 1);
    cp_async_commit();
    const int bn = (n & 1) * geo.pitch_a, bz = ((n + 1) & 1) * geo.pitch_a;
    T C[R], D[R];
    if (fused) {
      // past the last plane the z item reads a stale slot and writes an
      // unread buffer
      yz_columns<T, G, B, R, kYRegs, true>(am + bn + yoff, ak + bn + yoff, bc, S, yb, ycm, yck, C,
                                           D, tile(n + 1) + zoff_u, am + bz + zoff_a,
                                           ak + bz + zoff_a, P);
    } else {
      if (n + 1 < nplanes)
        z_phase<T, G, B, R>(tile(n + 1), am + bz + am_row0, ak + bz + am_row0, bc, S, SP, P,
                            nzr, items);
      yz_columns<T, G, B, R, kYRegs, false>(am + bn + yoff, ak + bn + yoff, bc, S, yb, ycm, yck,
                                            C, D, nullptr, nullptr, nullptr, P);
    }
    const int x = xi0 + n, o = x - B;
    const bool store = o >= x0 && o < x1;
    x_step<T, G, B, R, true>(acc, C, D, xc + x * W, store,
                             store ? obase + static_cast<size_t>(o) * SS : nullptr, S, nvalid,
                             scale);
  }
  // planes past the patch's end contribute nothing: store the rest of the ring
  const T none[R] = {};
#pragma unroll 1
  for (int x = xi1; x < x1 + B; ++x) {
    const int o = x - B;
    const bool store = o >= x0 && o < x1;
    x_step<T, G, B, R, false>(acc, none, none, nullptr, store,
                              store ? obase + static_cast<size_t>(o) * SS : nullptr, S, nvalid,
                              scale);
  }
}

// ------------------------------------------------------------------ host

int g_nsm[kMaxDevices];
int g_smem_optin[kMaxDevices];

// Largest number of distinct shared-memory words that one bank serves in
// one access of a warp whose lane q (of `count`) reads value addr(q) of
// type T (32 banks of 4 bytes; 8-byte values go as half-warps, 2-byte
// values share a word).
template <typename T, typename F>
int bank_conflicts(int count, F addr) {
  constexpr int lanes = sizeof(T) == 8 ? 16 : 32;
  int worst = 1;
  for (int w0 = 0; w0 < count; w0 += lanes) {
    int seen[32], n = 0, per_bank[32] = {0};
    for (int q = w0; q < std::min(w0 + lanes, count); ++q) {
      const int a = sizeof(T) == 2 ? addr(q) / 2 : addr(q);
      bool dup = false;
      for (int k = 0; k < n; ++k) dup = dup || seen[k] == a;
      if (!dup) {
        seen[n++] = a;
        worst = std::max(worst, ++per_bank[a % lanes]);
      }
    }
  }
  return worst;
}

template <typename G, int B>
size_t smem_bytes(const Geometry& g) {
  using T = typename Compute<G>::T;
  constexpr size_t kStages = sizeof(G) == 2 ? kHalfStages : Traits<T>::kStages;
  return 2 * static_cast<size_t>(g.S) * (2 * B + 1) * sizeof(typename Traits<T>::T2) +
         kStages * g.pitch_u * sizeof(G) + 4 * static_cast<size_t>(g.pitch_a) * sizeof(T);
}

// Block geometry for S; the AM / AK pitch keeps shared memory within
// max_smem where it can (the caller checks smem_bytes).
template <typename G, int B, int R>
Geometry make_geometry(int S, size_t max_smem) {
  using T = typename Compute<G>::T;
  Geometry g;
  g.S = S;
  g.ncz = (S + R - 1) / R;
  const int nch_max = kMaxThreads / S;
  g.nty = (g.ncz + nch_max - 1) / nch_max;
  const int nch = (g.ncz + g.nty - 1) / g.nty;
  g.H = nch * R;
  g.nslab = 1;
  g.tile_rows = std::min(S, g.H + 2 * B);
  g.am_rows = g.H + 2 * B;
  const int threads = nch * S, rows = g.tile_rows;
  const int items = std::min(threads, g.ncz * rows);
  // u tile rows: B zero columns, S values, zeros to ncz R + B; of the 32
  // smallest pitches, the one with the fewest bank conflicts in the z window
  // (bfloat16: pitches of the parity of S, for a tile that starts 0 or 1
  // value into its slot, and slots of whole 16-byte words)
  constexpr bool kHalf = sizeof(G) == 2;
  const int sp0 = g.ncz * R + 2 * B + (kHalf ? (g.ncz * R + 2 * B - S) & 1 : 0);
  auto tile_pitch = [&](int sp) {
    return kHalf ? (rows * sp + 1 + 7) / 8 * 8 : (rows * sp + 3) / 4 * 4;
  };
  int best_sp = 1 << 30;
  g.SP = sp0;
  for (int sp = sp0; sp < sp0 + 32; sp += kHalf ? 2 : 1) {
    int c = 0;
    for (int sh = 0; sh <= (kHalf ? 1 : 0); ++sh)
      c = std::max(c, bank_conflicts<G>(
                          items, [&](int q) { return sh + (q % rows) * sp + (q / rows) * R; }));
    if (c < best_sp) best_sp = c, g.SP = sp;
  }
  g.pitch_u = tile_pitch(g.SP);
  // of the 32 smallest AM / AK pitches, the one with the fewest bank
  // conflicts between a warp's lanes (y reads and z writes)
  int best = 1 << 30;
  g.P = g.am_rows;
  for (int pa = g.am_rows; pa < g.am_rows + 32; ++pa) {
    const int cy = bank_conflicts<T>(threads, [&](int t) { return (t % S) * pa + (t / S) * R; });
    const int cz = bank_conflicts<T>(items, [&](int q) { return (q / rows) * R * pa + q % rows; });
    if (std::max(cy, cz) < best) best = std::max(cy, cz), g.P = pa;
  }
  g.pitch_a = (g.ncz * R * g.P + 3) / 4 * 4;
  if (smem_bytes<G, B>(g) > max_smem) {
    g.SP = sp0;
    g.P = g.am_rows;
    g.pitch_u = tile_pitch(g.SP);
    g.pitch_a = (g.ncz * R * g.P + 3) / 4 * 4;
  }
  return g;
}

template <typename G, int B, int R>
int launch_rows(const void* u, const void* KS, const void* MS, const void* pscale, void* out,
                int NP, int S, int device, void* stream) {
  // geometry and occupancy depend on S only: computed once per S
  struct Cached {
    Geometry geo;
    size_t smem;
    int threads, occ;
  };
  static Cached cache[kMaxThreads + 1];
  Cached& c = cache[S];
  if (c.occ == 0) {
    c.geo = make_geometry<G, B, R>(S, g_smem_optin[device]);
    c.smem = smem_bytes<G, B>(c.geo);
    c.threads = c.geo.H / R * S;
    if (c.smem > static_cast<size_t>(g_smem_optin[device]))
      return static_cast<int>(cudaErrorInvalidValue);
    int occ = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, fused_stencil<G, B, R>, c.threads, c.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (occ <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    c.occ = occ;
  }
  // x-slabs: fewest (waves x input planes per block), the fewer slabs on a tie
  Geometry geo = c.geo;
  const long slots = static_cast<long>(g_nsm[device]) * c.occ;
  const long items = static_cast<long>(NP) * geo.nty;
  long best = -1;
  for (int ns = 1; ns <= S; ++ns) {
    const long waves = (items * ns + slots - 1) / slots;
    const long planes = std::min(S, (S + ns - 1) / ns + (ns > 1 ? 2 * B : 0));
    if (best < 0 || waves * planes < best) {
      best = waves * planes;
      geo.nslab = ns;
    }
  }
  const long blocks = items * geo.nslab;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidConfiguration);
  fused_stencil<G, B, R><<<static_cast<unsigned>(blocks), c.threads, c.smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const G*>(u), static_cast<const G*>(KS), static_cast<const G*>(MS),
      static_cast<const G*>(pscale), static_cast<G*>(out), geo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int B>
int launch(const void* u, const void* KS, const void* MS, const void* pscale, void* out,
           int NP, int S, int device, void* stream) {
  if (NP <= 0 || S <= B || S > kMaxThreads || device < 0 || device >= kMaxDevices ||
      g_nsm[device] == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // this library carries its own CUDA runtime: point it at the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return S * S <= kMaxThreads
             ? launch_rows<T, B, 1>(u, KS, MS, pscale, out, NP, S, device, stream)
             : launch_rows<T, B, kRowsLarge>(u, KS, MS, pscale, out, NP, S, device, stream);
}

template <typename T>
int dispatch(const void* u, const void* KS, const void* MS, const void* pscale, void* out,
             int NP, int S, int band, int device, void* stream) {
  switch (band) {
#define PS_CASE(b) \
  case b:          \
    return launch<T, b>(u, KS, MS, pscale, out, NP, S, device, stream);
    PS_CASE(1) PS_CASE(2) PS_CASE(3) PS_CASE(4)
    PS_CASE(5) PS_CASE(6) PS_CASE(7) PS_CASE(8)
#undef PS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int B>
cudaError_t opt_in(int bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      fused_stencil<T, B, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fused_stencil<T, B, kRowsLarge>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
cudaError_t opt_in_all(int bytes) {
  const cudaError_t es[kMaxBand] = {opt_in<T, 1>(bytes), opt_in<T, 2>(bytes),
                                    opt_in<T, 3>(bytes), opt_in<T, 4>(bytes),
                                    opt_in<T, 5>(bytes), opt_in<T, 6>(bytes),
                                    opt_in<T, 7>(bytes), opt_in<T, 8>(bytes)};
  for (cudaError_t e : es)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Once per card, before its first launch: shared-memory opt-in of every
// kernel instance (above 48 KB it must be opted into) and the SM count.
int patch_stencil_init(int device) {
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int nsm = 0, optin = 0;
  e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = opt_in_all<float>(optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = opt_in_all<double>(optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = opt_in_all<__nv_bfloat16>(optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  g_smem_optin[device] = optin;
  g_nsm[device] = nsm;
  return 0;
}

int patch_stencil_max_band() { return kMaxBand; }

int patch_stencil_f32(const void* u, const void* KS, const void* MS, const void* pscale,
                      void* out, int NP, int S, int band, int device, void* stream) {
  return dispatch<float>(u, KS, MS, pscale, out, NP, S, band, device, stream);
}

int patch_stencil_f64(const void* u, const void* KS, const void* MS, const void* pscale,
                      void* out, int NP, int S, int band, int device, void* stream) {
  return dispatch<double>(u, KS, MS, pscale, out, NP, S, band, device, stream);
}

int patch_stencil_bf16(const void* u, const void* KS, const void* MS, const void* pscale,
                       void* out, int NP, int S, int band, int device, void* stream) {
  return dispatch<__nv_bfloat16>(u, KS, MS, pscale, out, NP, S, band, device, stream);
}

const char* patch_stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
