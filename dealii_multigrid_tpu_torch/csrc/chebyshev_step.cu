// One step of the Chebyshev-Jacobi smoother (solvers/chebyshev.py) as one
// pass over a level's slot vector, float and double.
//
// The smoother's step on a vector of N slots is, after the operator's
// result before its identity blend (ar = HybridOperator.vmult_split):
//
//   ax = ar ck + x (1 - ck)          the blend on constrained slots
//   r  = b - ax
//   d' = c_d d + c_r (inv_diag r)    the three-term recurrence, or
//   d' = (inv_diag r) inv_theta      the first step from a given x
//   x' = x + d'
//
// PyTorch's eager chain does this in ten elementwise kernels (eight in the
// first step) and 27 accesses of N values (22); the pass here reads ar, ck,
// x, b, d and inv_diag once and writes d' and x' once: 8 accesses (7 in the
// first step, which reads no d; 7 also where x and d are one tensor, the
// first recurrence step of a smoothing from zero).
//
// Same result as the chain, bit for bit.  Every operation is the chain's,
// in its order, each rounded to nearest on its own (__fmul_rn, __fadd_rn,
// ...), so that nvcc contracts nothing into a fused multiply-add.  The
// chain's CUDA kernels round each of their operations the same way:
// PyTorch's add and sub compute a + alpha b with alpha = +-1, exact in
// either form.  The first step's division by theta, a CPU scalar, is a
// multiplication by the reciprocal in PyTorch's CUDA kernel
// (div_true_kernel_cuda); the host passes that reciprocal, computed in the
// vector's dtype as PyTorch computes it.  c_d and c_r come from the host in
// the vector's dtype, so the double they travel in converts back exactly.
//
// Bound by bytes: at N = 18,399,744 (cell 3's finest level) the 8 float32
// accesses move 589 MB, 0.176 ms at 3.35 TB/s.  Each thread moves 16-byte
// vectors (4 floats or 2 doubles) in a grid-stride loop over a grid that
// fills every SM (kBlocksPerSm blocks of kThreads), with no shared memory.
// A vector whose address is not 16-byte aligned takes the same loop one
// value at a time.  ck and inv_diag are read as they are: precomputing
// 1 - ck would add a vector of N values to the level.
//
// Launches go on the caller's stream and never synchronise; each entry
// point returns cudaGetLastError() so a refused launch is reported to the
// wrapper.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2,048 resident threads an SM
constexpr int kMaxDevices = 64;

int g_nsm[kMaxDevices];

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using V = float4;
  static constexpr int kWidth = 4;
};
template <>
struct Vec<double> {
  using V = double2;
  static constexpr int kWidth = 2;
};

template <typename T>
struct Coeffs {
  T c_d, c_r, inv_theta;
};

// one slot: (d', x') from (ar, ck, x, b, d, inv_diag)
template <typename T, bool kFirst>
__device__ __forceinline__ void point(T ar, T ck, T x, T b, T d, T inv, const Coeffs<T>& c,
                                      T& d_out, T& x_out) {
  const T ax = add(mul(ar, ck), mul(x, sub(T(1), ck)));
  const T z = mul(inv, sub(b, ax));
  const T dn = kFirst ? mul(z, c.inv_theta) : add(mul(c.c_d, d), mul(c.c_r, z));
  d_out = dn;
  x_out = add(x, dn);
}

template <typename T, bool kFirst>
__device__ __forceinline__ void lanes(const float4& ar, const float4& ck, const float4& x,
                                      const float4& b, const float4& d, const float4& inv,
                                      const Coeffs<float>& c, float4& d_out, float4& x_out) {
  point<float, kFirst>(ar.x, ck.x, x.x, b.x, d.x, inv.x, c, d_out.x, x_out.x);
  point<float, kFirst>(ar.y, ck.y, x.y, b.y, d.y, inv.y, c, d_out.y, x_out.y);
  point<float, kFirst>(ar.z, ck.z, x.z, b.z, d.z, inv.z, c, d_out.z, x_out.z);
  point<float, kFirst>(ar.w, ck.w, x.w, b.w, d.w, inv.w, c, d_out.w, x_out.w);
}

template <typename T, bool kFirst>
__device__ __forceinline__ void lanes(const double2& ar, const double2& ck, const double2& x,
                                      const double2& b, const double2& d, const double2& inv,
                                      const Coeffs<double>& c, double2& d_out, double2& x_out) {
  point<double, kFirst>(ar.x, ck.x, x.x, b.x, d.x, inv.x, c, d_out.x, x_out.x);
  point<double, kFirst>(ar.y, ck.y, x.y, b.y, d.y, inv.y, c, d_out.y, x_out.y);
}

// kFirst: the first step (no d is read); kVec: every pointer is 16-byte
// aligned, so the body moves 16-byte vectors; alias: x and d are one tensor
template <typename T, bool kFirst, bool kVec>
__global__ void __launch_bounds__(kThreads)
    chebyshev_step(const T* __restrict__ ar, const T* __restrict__ ck, const T* x, const T* b,
                   const T* d, const T* __restrict__ inv, T* d_out, T* x_out, int64_t n,
                   Coeffs<T> c, bool alias) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t tail = 0;
  if (kVec) {
    using V = typename Vec<T>::V;
    constexpr int W = Vec<T>::kWidth;
    const int64_t nv = n / W;
    for (int64_t i = tid; i < nv; i += stride) {
      const V xv = reinterpret_cast<const V*>(x)[i];
      V dv = xv;
      if (!kFirst && !alias) dv = reinterpret_cast<const V*>(d)[i];
      V dn, xn;
      lanes<T, kFirst>(reinterpret_cast<const V*>(ar)[i], reinterpret_cast<const V*>(ck)[i], xv,
                       reinterpret_cast<const V*>(b)[i], dv, reinterpret_cast<const V*>(inv)[i],
                       c, dn, xn);
      reinterpret_cast<V*>(d_out)[i] = dn;
      reinterpret_cast<V*>(x_out)[i] = xn;
    }
    tail = nv * W;
  }
  for (int64_t i = tail + tid; i < n; i += stride) {
    const T xv = x[i];
    const T dv = (kFirst || alias) ? xv : d[i];
    point<T, kFirst>(ar[i], ck[i], xv, b[i], dv, inv[i], c, d_out[i], x_out[i]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, bool kFirst, bool kVec>
void launch_grid(const T* ar, const T* ck, const T* x, const T* b, const T* d, const T* inv,
                 T* d_out, T* x_out, int64_t n, Coeffs<T> c, int device, cudaStream_t stream) {
  const int64_t units = kVec ? n / Vec<T>::kWidth + n % Vec<T>::kWidth : n;
  const int64_t full = static_cast<int64_t>(g_nsm[device]) * kBlocksPerSm;
  int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > full) blocks = full;
  if (blocks < 1) blocks = 1;
  chebyshev_step<T, kFirst, kVec><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      ar, ck, x, b, d, inv, d_out, x_out, n, c, x == d);
}

template <typename T>
int launch(const void* ar, const void* ck, const void* x, const void* b, const void* d,
           const void* inv, void* d_out, void* x_out, long long n, int first, double c_d,
           double c_r, double inv_theta, int device, void* stream) {
  if (n < 0 || device < 0 || device >= kMaxDevices || g_nsm[device] == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  // this library carries its own CUDA runtime: point it at the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Coeffs<T> c{static_cast<T>(c_d), static_cast<T>(c_r), static_cast<T>(inv_theta)};
  const T *a = static_cast<const T*>(ar), *k = static_cast<const T*>(ck),
          *xs = static_cast<const T*>(x), *bs = static_cast<const T*>(b),
          *ds = first ? xs : static_cast<const T*>(d), *iv = static_cast<const T*>(inv);
  T *dn = static_cast<T*>(d_out), *xn = static_cast<T*>(x_out);
  const bool vec = aligned16(a) && aligned16(k) && aligned16(xs) && aligned16(bs) &&
                   aligned16(ds) && aligned16(iv) && aligned16(dn) && aligned16(xn);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t m = static_cast<int64_t>(n);
  if (first) {
    if (vec) launch_grid<T, true, true>(a, k, xs, bs, ds, iv, dn, xn, m, c, device, s);
    else launch_grid<T, true, false>(a, k, xs, bs, ds, iv, dn, xn, m, c, device, s);
  } else {
    if (vec) launch_grid<T, false, true>(a, k, xs, bs, ds, iv, dn, xn, m, c, device, s);
    else launch_grid<T, false, false>(a, k, xs, bs, ds, iv, dn, xn, m, c, device, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Once per card, before its first launch: the SM count the grid fills.
int chebyshev_step_init(int device) {
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int nsm = 0;
  e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  g_nsm[device] = nsm;
  return 0;
}

// (d_out, x_out) of one step on n slots; first != 0: the first step (d is
// not read; inv_theta scales), else the recurrence (c_d, c_r)
int chebyshev_step_f32(const void* ar, const void* ck, const void* x, const void* b,
                       const void* d, const void* inv, void* d_out, void* x_out, long long n,
                       int first, double c_d, double c_r, double inv_theta, int device,
                       void* stream) {
  return launch<float>(ar, ck, x, b, d, inv, d_out, x_out, n, first, c_d, c_r, inv_theta,
                       device, stream);
}

int chebyshev_step_f64(const void* ar, const void* ck, const void* x, const void* b,
                       const void* d, const void* inv, void* d_out, void* x_out, long long n,
                       int first, double c_d, double c_r, double inv_theta, int device,
                       void* stream) {
  return launch<double>(ar, ck, x, b, d, inv, d_out, x_out, n, first, c_d, c_r, inv_theta,
                        device, stream);
}

const char* chebyshev_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
