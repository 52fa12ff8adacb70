// Sum-factorized patch Laplacian on Hopper (sm_90a), float and double.
//
// Replaces the TPU kernel dealii_multigrid_tpu/ops/pallas_stencil.py
// (_kernel / patch_stencil_pallas, pl.pallas_call at :71).  Per patch p of
// the [NP, S, S, S] lattice bucket (axes x, y, z; z fastest):
//
//   out[p] = pscale[p] * (KS_x MS_y MS_z + MS_x KS_y MS_z + MS_x MS_y KS_z) u[p]
//
// where KS, MS are the assembled 1D patch stiffness and mass matrices
// [S, S] and A_a contracts lattice axis a: (A_a u)[.., i, ..] =
// sum_j A[i, j] u[.., j, ..].  Factored as
//
//   C = MS_y MS_z u,  D = (KS_y MS_z + MS_y KS_z) u,  out = pscale (KS_x C + MS_x D)
//
// it costs 7 axis contractions instead of 9, in two passes:
//   pass 1 (plane_pass):  one block per (patch, x-plane) -> scratch C and D;
//   pass 2 (x_pass):      one block per (patch, y-row)   -> out.
// A single f32 patch at S = 33 is 143,748 B, so a patch plus one volume
// intermediate would not fit the 227 KB of shared memory a block may use;
// each pass here keeps only S x S planes (a plane, two plane
// intermediates, KS and MS: 5 S^2 values, 21.8 KB in f32 and 43.6 KB in f64
// at S = 33).
//
// What bounds it on the card: device-memory traffic is 6 x NP x S^3 values
// (read u, write and read C and D, write out) against a minimum of 2; the
// dense work is 7 contractions x 2 S^4 flops per patch, about 58 flops per
// byte of the minimal traffic at S = 33 in f32 -- above the H100's FP32
// FMA-to-bandwidth balance, so done dense the kernel is bound by FMA
// throughput.  KS and MS are banded (at most 2p + 1 = 9 nonzeros per row
// for p = 4); using the band would cut the work about 3.7x.  That, fusing
// the two passes, TMA/wgmma staging and fusing the Chebyshev update into
// the epilogue are later work: this version is the simple correct one.
//
// Plain FP32/FP64 FMA throughout; no TF32.  Launches go on the caller's
// stream and never synchronise; each entry point returns
// cudaGetLastError() so a refused launch is reported to the wrapper.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void plane_pass(const T* __restrict__ u, const T* __restrict__ KS,
                           const T* __restrict__ MS, T* __restrict__ C,
                           T* __restrict__ D, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sM = sK + S * S;
  T* sU = sM + S * S;
  T* sAM = sU + S * S;
  T* sAK = sAM + S * S;
  const int SS = S * S;
  // block b = patch * S + x: the plane u[p, x, :, :] is contiguous
  const size_t base = static_cast<size_t>(blockIdx.x) * SS;
  for (int t = threadIdx.x; t < SS; t += blockDim.x) {
    sK[t] = KS[t];
    sM[t] = MS[t];
    sU[t] = u[base + t];
  }
  __syncthreads();
  // z contraction: AM[j', k] = sum_k' MS[k, k'] u[j', k'], AK likewise
  for (int t = threadIdx.x; t < SS; t += blockDim.x) {
    const int jp = t / S;
    const int k = t - jp * S;
    T am = T(0), ak = T(0);
    for (int kp = 0; kp < S; ++kp) {
      const T v = sU[jp * S + kp];
      am = fma(sM[k * S + kp], v, am);
      ak = fma(sK[k * S + kp], v, ak);
    }
    sAM[t] = am;
    sAK[t] = ak;
  }
  __syncthreads();
  // y contraction: C[j, k] = sum_j' MS[j, j'] AM[j', k],
  //                D[j, k] = sum_j' KS[j, j'] AM[j', k] + MS[j, j'] AK[j', k]
  for (int t = threadIdx.x; t < SS; t += blockDim.x) {
    const int j = t / S;
    const int k = t - j * S;
    T c = T(0), d = T(0);
    for (int jp = 0; jp < S; ++jp) {
      const T am = sAM[jp * S + k];
      const T m = sM[j * S + jp];
      c = fma(m, am, c);
      d = fma(sK[j * S + jp], am, d);
      d = fma(m, sAK[jp * S + k], d);
    }
    C[base + t] = c;
    D[base + t] = d;
  }
}

template <typename T>
__global__ void x_pass(const T* __restrict__ C, const T* __restrict__ D,
                       const T* __restrict__ KS, const T* __restrict__ MS,
                       const T* __restrict__ pscale, T* __restrict__ out,
                       int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sM = sK + S * S;
  T* sC = sM + S * S;
  T* sD = sC + S * S;
  const int SS = S * S;
  // block b = patch * S + j: the row set [p, :, j, :] (x stride S^2)
  const int p = blockIdx.x / S;
  const int j = blockIdx.x - p * S;
  const size_t pbase = static_cast<size_t>(p) * SS * S;
  for (int t = threadIdx.x; t < SS; t += blockDim.x) {
    const int xp = t / S;
    const int k = t - xp * S;
    const size_t g = pbase + (static_cast<size_t>(xp) * S + j) * S + k;
    sK[t] = KS[t];
    sM[t] = MS[t];
    sC[t] = C[g];
    sD[t] = D[g];
  }
  __syncthreads();
  const T scale = pscale[p];
  // x contraction: out[i, j, k] = scale * sum_x' KS[i, x'] C[x', j, k]
  //                                             + MS[i, x'] D[x', j, k]
  for (int t = threadIdx.x; t < SS; t += blockDim.x) {
    const int i = t / S;
    const int k = t - i * S;
    T acc = T(0);
    for (int xp = 0; xp < S; ++xp) {
      acc = fma(sK[i * S + xp], sC[xp * S + k], acc);
      acc = fma(sM[i * S + xp], sD[xp * S + k], acc);
    }
    out[pbase + (static_cast<size_t>(i) * S + j) * S + k] = scale * acc;
  }
}

template <typename T>
int launch(const void* u, const void* KS, const void* MS, const void* pscale,
           void* C, void* D, void* out, int NP, int S, int device,
           void* stream) {
  if (NP <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // this library carries its own CUDA runtime: point it at the tensors' card
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem1 = 5 * static_cast<size_t>(S) * S * sizeof(T);
  const size_t smem2 = 4 * static_cast<size_t>(S) * S * sizeof(T);
  // above 48 KB, dynamic shared memory must be opted into per kernel
  e = cudaFuncSetAttribute(plane_pass<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem1));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(x_pass<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem2));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned int blocks = static_cast<unsigned int>(NP) * S;
  plane_pass<T><<<blocks, kThreads, smem1, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(KS),
      static_cast<const T*>(MS), static_cast<T*>(C), static_cast<T*>(D), S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  x_pass<T><<<blocks, kThreads, smem2, st>>>(
      static_cast<const T*>(C), static_cast<const T*>(D),
      static_cast<const T*>(KS), static_cast<const T*>(MS),
      static_cast<const T*>(pscale), static_cast<T*>(out), S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int patch_stencil_f32(const void* u, const void* KS, const void* MS,
                      const void* pscale, void* C, void* D, void* out, int NP,
                      int S, int device, void* stream) {
  return launch<float>(u, KS, MS, pscale, C, D, out, NP, S, device, stream);
}

int patch_stencil_f64(const void* u, const void* KS, const void* MS,
                      const void* pscale, void* C, void* D, void* out, int NP,
                      int S, int device, void* stream) {
  return launch<double>(u, KS, MS, pscale, C, D, out, NP, S, device, stream);
}

const char* patch_stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
