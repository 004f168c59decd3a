// Shared pieces of the delta/beta multislice kernels (K1 in
// multislice_db_stored.cu, K4 in multislice_db.cu): storage-type helpers,
// the slice transmission, the shared-memory complex matmul and the folded
// propagation, the forward sweep both kernels run, and the deterministic
// cross-mode sum of their backward sweeps.
//
// Layouts (row-major): db [S, 2, N, P] (slot 0 delta, slot 1 beta, P =
// ny*nx); waves [M, N, P] complex; records [S, M, N, P] complex pairs of T;
// mats complex [n, n].  Every kernel runs one block per (patch n, probe
// mode m), blockIdx.x = n*M + m, so a block holds one wave in shared memory
// whatever M is.  The backward sweeps need gt = sum_m a_m w_m across the
// blocks of a patch: they launch as a thread-block cluster of the patch's M
// blocks (see cross_mode_sum).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msdb {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kRowsPerThread = 4;
// The portable thread-block cluster size: the backward sweeps take at most
// this many probe modes.
constexpr int kMaxModes = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A complex value stored as an interleaved (re, im) pair of T.
__device__ __forceinline__ void store_pair(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Slice transmission exp(-k1 b) exp(-i s k1 d), evaluated in f32 with the
// accurate (not the fast-math) exp and sincos.
__device__ __forceinline__ float2 modulator(float d, float b, float neg_k1,
                                            float neg_sk1) {
  const float amp = expf(neg_k1 * b);
  float sn, cs;
  sincosf(neg_sk1 * d, &sn, &cs);
  return make_float2(amp * cs, amp * sn);
}

// The transmission t and its inverse 1/t = exp(+k1 b) exp(+i s k1 d), each
// from its own exponential (no division), as _bwd_db_kernel computes them.
__device__ __forceinline__ void modulator_and_inverse(float d, float b,
                                                      float neg_k1,
                                                      float neg_sk1,
                                                      float2* t,
                                                      float2* t_inv) {
  const float amp = expf(neg_k1 * b);
  const float inv_amp = expf(-neg_k1 * b);
  float sn, cs;
  sincosf(neg_sk1 * d, &sn, &cs);
  *t = make_float2(amp * cs, amp * sn);
  *t_inv = make_float2(inv_amp * cs, -inv_amp * sn);
}

// C = A B for complex row-major matrices in shared memory: A is R x K,
// B is K x Cn, C is R x Cn.  C must alias neither A nor B.  kConjA/kConjB
// read A or B conjugated.
template <bool kConjA, bool kConjB>
__device__ __forceinline__ void cmatmul_smem(const float2* __restrict__ A,
                                             const float2* __restrict__ B,
                                             float2* __restrict__ C, int R,
                                             int K, int Cn) {
  const int n_groups = (R + kRowsPerThread - 1) / kRowsPerThread;
  const int n_items = n_groups * Cn;
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int c = item % Cn;
    const int r0 = (item / Cn) * kRowsPerThread;
    const float2* rows[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      rows[i] = A + min(r0 + i, R - 1) * K;
    }
    float acc_r[kRowsPerThread], acc_i[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      acc_r[i] = 0.f;
      acc_i[i] = 0.f;
    }
    for (int k = 0; k < K; ++k) {
      float2 b = B[k * Cn + c];
      if (kConjB) b.y = -b.y;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        float2 a = rows[i][k];
        if (kConjA) a.y = -a.y;
        acc_r[i] = fmaf(a.x, b.x, acc_r[i]);
        acc_r[i] = fmaf(-a.y, b.y, acc_r[i]);
        acc_i[i] = fmaf(a.x, b.y, acc_i[i]);
        acc_i[i] = fmaf(a.y, b.x, acc_i[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      if (r0 + i < R) C[(r0 + i) * Cn + c] = make_float2(acc_r[i], acc_i[i]);
    }
  }
}

// The same product as a function call of its own.
template <bool kConjA, bool kConjB>
__device__ __noinline__ void cmatmul_smem_call(const float2* __restrict__ A,
                                               const float2* __restrict__ B,
                                               float2* __restrict__ C, int R,
                                               int K, int Cn) {
  cmatmul_smem<kConjA, kConjB>(A, B, C, R, K, Cn);
}

// w <- Ay w Bx for one ny x nx plane, through the scratch plane; with
// kConj, w <- conj(Ay) w conj(Bx).  Ends with a barrier, so the caller may
// reuse w, scr and the mats at once.  kCall runs the two products as calls
// (cmatmul_smem_call) instead of inline.  The forward sweep calls, the
// backward sweeps inline: tools/ab_multislice_inline.py timed both ways on
// an H100 (700 W), at 32 steps of 529 patches of 72x72 the forward takes
// 5.38 ms with calls against 6.90 ms inline and the backward 6.06 ms inline
// against 6.94 ms with calls (K4 at 256 steps and 3 modes: 108 against 138
// ms, 247 against 268 ms).  The two sweeps compile to different register
// allocations and schedules of the same loop.
template <bool kConj = false, bool kCall = false>
__device__ __forceinline__ void propagate(float2* w, float2* scr,
                                          const float2* ay, const float2* bx,
                                          int ny, int nx) {
  if (kCall) {
    cmatmul_smem_call<false, kConj>(w, bx, scr, ny, nx, nx);
  } else {
    cmatmul_smem<false, kConj>(w, bx, scr, ny, nx, nx);
  }
  __syncthreads();
  if (kCall) {
    cmatmul_smem_call<kConj, false>(ay, scr, w, ny, ny, nx);
  } else {
    cmatmul_smem<kConj, false>(ay, scr, w, ny, ny, nx);
  }
  __syncthreads();
}

__device__ __forceinline__ void copy_to_smem(float2* dst,
                                             const float2* __restrict__ src,
                                             int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// Dynamic shared memory of a block holding `planes` ny x nx complex planes
// and one ny x ny and one nx x nx matrix.
inline size_t smem_bytes(int planes, int ny, int nx) {
  return sizeof(float2) * ((size_t)planes * ny * nx + (size_t)ny * ny +
                           (size_t)nx * nx);
}

// The forward sweep of one (patch, mode) block: per step the modulation
// (recording the entering wave in T when kRecords), then the folded step
// propagation, or at the last step the far-field mats when given.
template <typename T, bool kRecords>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ db, const float2* __restrict__ w0,
               const float2* __restrict__ ay, const float2* __restrict__ bx,
               const float2* __restrict__ fay, const float2* __restrict__ fbx,
               float2* __restrict__ out, T* __restrict__ rec, int S, int M,
               int N, int ny, int nx, float neg_k1, float neg_sk1) {
  extern __shared__ float2 smem[];
  const int P = ny * nx;
  float2* w = smem;
  float2* scr = w + P;
  float2* may = scr + P;
  float2* mbx = may + ny * ny;
  const int n = blockIdx.x / M;
  const int m = blockIdx.x - n * M;
  const size_t wave_off = ((size_t)m * N + n) * P;

  copy_to_smem(w, w0 + wave_off, P);
  copy_to_smem(may, ay, ny * ny);
  copy_to_smem(mbx, bx, nx * nx);
  __syncthreads();

  for (int z = 0; z < S; ++z) {
    const T* d = db + ((size_t)(2 * z) * N + n) * P;
    const T* b = db + ((size_t)(2 * z + 1) * N + n) * P;
    T* rz = kRecords ? rec + (((size_t)z * M + m) * N + n) * P * 2 : nullptr;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const float2 t = modulator(to_float(d[p]), to_float(b[p]), neg_k1,
                                 neg_sk1);
      const float2 wv = w[p];
      if (kRecords) store_pair(rz + 2 * p, wv);
      w[p] = cmul(wv, t);
    }
    __syncthreads();
    if (z == S - 1) {
      if (fay == nullptr) break;
      // No thread reads the step mats after the barrier above.
      copy_to_smem(may, fay, ny * ny);
      copy_to_smem(mbx, fbx, nx * nx);
      __syncthreads();
    }
    propagate<false, true>(w, scr, may, mbx, ny, nx);
  }

  for (int e = threadIdx.x; e < P; e += blockDim.x) out[wave_off + e] = w[e];
}

// The slice gradient of one backward step from gt = sum_m a_m w_m:
// cu = gt t, then gb = -k1 Re(cu), gd = s k1 Im(cu), each rounded once to T
// (_bwd_db_st_kernel's chain through t = exp(u)).
template <typename T>
__device__ __forceinline__ void store_slice_grad(T* gd, T* gb, int p,
                                                 float2 gt, float2 t,
                                                 float neg_k1, float sk1) {
  const float2 cu = cmul(gt, t);
  gb[p] = from_float<T>(neg_k1 * cu.x);
  gd[p] = from_float<T>(sk1 * cu.y);
}

// The cross-mode sum of one backward step, for M > 1.  Every block of the
// patch's cluster has put its mode's product a_m w_m into `part` (its own
// scratch plane).  After the cluster barrier, block m sums all M planes for
// its share of the pixels, reading the other blocks' shared memory in place,
// in mode order and in f32, and stores gdb there; the second barrier keeps
// every plane alive until all blocks have read it.  No atomics: the result
// does not depend on timing.  t is recomputed from db for the block's
// pixels (L2 holds the step's planes).
template <typename T>
__device__ void cross_mode_sum(float2* part, const T* d, const T* b, T* gd,
                               T* gb, int P, int M, int m, float neg_k1,
                               float neg_sk1, float sk1) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = (P + M - 1) / M;
  const int p0 = m * share;
  const int p1 = min(P, p0 + share);
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    float2 gt = make_float2(0.f, 0.f);
    for (int r = 0; r < M; ++r) {
      const float2 v = cluster.map_shared_rank(part, r)[p];
      gt.x += v.x;
      gt.y += v.y;
    }
    const float2 t = modulator(to_float(d[p]), to_float(b[p]), neg_k1,
                               neg_sk1);
    store_slice_grad(gd, gb, p, gt, t, neg_k1, sk1);
  }
  cluster.sync();
}

// Launches `kernel` over N*M blocks: plainly at M = 1, else as clusters of
// the M blocks of one patch.  Returns the CUDA error code.
template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), int N, int M, size_t smem,
           bool cluster, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)N * (unsigned)M);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (cluster && M > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)M;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace msdb
