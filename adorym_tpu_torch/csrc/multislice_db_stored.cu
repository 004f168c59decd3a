// Multislice propagation with stored intermediates, delta/beta object:
// forward (k1_fwd) and backward (k1_bwd) sweeps over the z steps.
//
// Replaces the Pallas kernels of adorym_tpu/ops/pallas_multislice.py:
//   _fwd_db_st_kernel (:353, launched by _call_fwd_db_st :1009) and
//   _bwd_db_st_kernel (:422, launched by _call_bwd_db_st :1059),
// the custom-VJP pair behind multislice_db_stored_packed (:1125).
//
// Math (per batch item n, probe mode m, binned step z = 0..S-1):
//   t_z   = exp(-k1 b_z) exp(-i s k1 d_z)
//   rec_z = w                                   (recorded in the db dtype)
//   w     = Ay (w t_z) Bx                        z < S-1: Ay = Py, Bx = Px^T
//   out   = Fy (w t_z) Fx^T  at z = S-1 when far-field mats are given,
//           else w t_{S-1}.
// The backward runs the JAX-convention (unconjugated) cotangent sweep of
// _bwd_db_st_kernel; the conversion from and to PyTorch's conjugate
// convention happens at the load of the incoming gradient and at the store
// of the wave gradient.  The mode sum gt = sum_m a w is taken inside the
// block in mode order: no atomics, deterministic.
//
// What bounds it on the H100: bytes.  At the flagship (S=32, M=1, N=529,
// 72x72, f32) one sweep moves about 1.45 GB of db, records and waves
// forward (2.15 GB backward), 0.43 / 0.64 ms at 3.35 TB/s.  Its 31
// propagations and far field need about 11.7 GFLOP when the transforms are
// FFTs (0.17 ms of f32 CUDA-core work).  The two 72-deep complex matmul
// passes per step this kernel runs instead do 76 GFLOP in the
// three-multiply form, 1.1 ms at the f32 peak.
//
// Design: one block per batch item.  The block keeps its M waves, one
// transpose-free scratch plane and the two folded per-axis propagation
// matrices in shared memory for the whole z scan, so the wavefield never
// leaves the SM between steps (the TPU kernel's one idea); device memory
// sees each db plane read once and each record written once.  The two
// matmul passes read shared memory only: each thread owns four output rows
// of one column, so every matrix element it loads feeds four complex
// multiply-adds.  Tensor cores (wgmma) are later work; this kernel runs
// plain f32 FMAs, so the f32 path is full f32 and bf16 is a storage type
// only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRowsPerThread = 4;

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

// C = A B for complex row-major matrices in shared memory: A is R x K,
// B is K x Cn, C is R x Cn.  C must alias neither A nor B.
__device__ void cmatmul_smem(const float2* __restrict__ A,
                             const float2* __restrict__ B,
                             float2* __restrict__ C, int R, int K, int Cn) {
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
      const float2 b = B[k * Cn + c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float2 a = rows[i][k];
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

// w <- Ay w Bx for one ny x nx plane, through the scratch plane.  Ends
// with a barrier, so the caller may reuse w, scr and the mats at once.
__device__ void propagate(float2* w, float2* scr, const float2* ay,
                          const float2* bx, int ny, int nx) {
  cmatmul_smem(w, bx, scr, ny, nx, nx);
  __syncthreads();
  cmatmul_smem(ay, scr, w, ny, ny, nx);
  __syncthreads();
}

__device__ void copy_to_smem(float2* dst, const float2* __restrict__ src,
                             int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// db [S, 2, N, P] (slot 0 delta, slot 1 beta); w0, out [M, N, P] complex;
// rec [S, M, N, P] complex pairs of T; mats complex [n, n] row-major.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ db, const float2* __restrict__ w0,
               const float2* __restrict__ ay, const float2* __restrict__ bx,
               const float2* __restrict__ fay, const float2* __restrict__ fbx,
               float2* __restrict__ out, T* __restrict__ rec, int S, int M,
               int N, int ny, int nx, float neg_k1, float neg_sk1) {
  extern __shared__ float2 smem[];
  const int P = ny * nx;
  float2* w = smem;
  float2* scr = w + M * P;
  float2* may = scr + P;
  float2* mbx = may + ny * ny;
  const int n = blockIdx.x;

  for (int e = threadIdx.x; e < M * P; e += blockDim.x) {
    const int m = e / P;
    w[e] = w0[((size_t)m * N + n) * P + (e - m * P)];
  }
  copy_to_smem(may, ay, ny * ny);
  copy_to_smem(mbx, bx, nx * nx);
  __syncthreads();

  for (int z = 0; z < S; ++z) {
    const T* d = db + ((size_t)(2 * z) * N + n) * P;
    const T* b = db + ((size_t)(2 * z + 1) * N + n) * P;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const float2 t = modulator(to_float(d[p]), to_float(b[p]), neg_k1,
                                 neg_sk1);
      for (int m = 0; m < M; ++m) {
        const float2 wv = w[m * P + p];
        store_pair(rec + (((size_t)z * M + m) * N + n) * P * 2 + 2 * p, wv);
        w[m * P + p] = cmul(wv, t);
      }
    }
    __syncthreads();
    const float2* step_y = may;
    const float2* step_x = mbx;
    if (z == S - 1) {
      if (fay == nullptr) break;
      // No thread reads the step mats after the barrier above.
      copy_to_smem(may, fay, ny * ny);
      copy_to_smem(mbx, fbx, nx * nx);
      __syncthreads();
    }
    for (int m = 0; m < M; ++m) {
      propagate(w + m * P, scr, step_y, step_x, ny, nx);
    }
  }

  for (int e = threadIdx.x; e < M * P; e += blockDim.x) {
    const int m = e / P;
    out[((size_t)m * N + n) * P + (e - m * P)] = w[e];
  }
}

// g, gw [M, N, P] complex in PyTorch's convention (the conjugate of
// JAX's cotangent); gdb [S, 2, N, P] in T.  ay/bx are the TRANSPOSED step
// mats (Py^T, Px) and fay/fbx the transposed far-field mats (Fy^T, Fx).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const T* __restrict__ db, const T* __restrict__ rec,
               const float2* __restrict__ g, const float2* __restrict__ ay,
               const float2* __restrict__ bx, const float2* __restrict__ fay,
               const float2* __restrict__ fbx, T* __restrict__ gdb,
               float2* __restrict__ gw, int S, int M, int N, int ny, int nx,
               float neg_k1, float neg_sk1, float sk1) {
  extern __shared__ float2 smem[];
  const int P = ny * nx;
  float2* a = smem;
  float2* scr = a + M * P;
  float2* may = scr + P;
  float2* mbx = may + ny * ny;
  const int n = blockIdx.x;

  for (int e = threadIdx.x; e < M * P; e += blockDim.x) {
    const int m = e / P;
    const float2 v = g[((size_t)m * N + n) * P + (e - m * P)];
    a[e] = make_float2(v.x, -v.y);
  }
  if (fay != nullptr) {
    copy_to_smem(may, fay, ny * ny);
    copy_to_smem(mbx, fbx, nx * nx);
    __syncthreads();
    for (int m = 0; m < M; ++m) propagate(a + m * P, scr, may, mbx, ny, nx);
  }
  copy_to_smem(may, ay, ny * ny);
  copy_to_smem(mbx, bx, nx * nx);
  __syncthreads();

  for (int z = S - 1; z >= 0; --z) {
    if (z < S - 1) {
      for (int m = 0; m < M; ++m) propagate(a + m * P, scr, may, mbx, ny, nx);
    }
    const T* d = db + ((size_t)(2 * z) * N + n) * P;
    const T* b = db + ((size_t)(2 * z + 1) * N + n) * P;
    T* gd = gdb + ((size_t)(2 * z) * N + n) * P;
    T* gb = gdb + ((size_t)(2 * z + 1) * N + n) * P;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const float2 t = modulator(to_float(d[p]), to_float(b[p]), neg_k1,
                                 neg_sk1);
      float2 gt = make_float2(0.f, 0.f);
      for (int m = 0; m < M; ++m) {
        const float2 wv =
            load_pair(rec + (((size_t)z * M + m) * N + n) * P * 2 + 2 * p);
        const float2 av = a[m * P + p];
        gt.x += av.x * wv.x - av.y * wv.y;
        gt.y += av.x * wv.y + av.y * wv.x;
      }
      const float2 cu = cmul(gt, t);
      gb[p] = from_float<T>(neg_k1 * cu.x);
      gd[p] = from_float<T>(sk1 * cu.y);
      for (int m = 0; m < M; ++m) a[m * P + p] = cmul(a[m * P + p], t);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < M * P; e += blockDim.x) {
    const int m = e / P;
    const float2 v = a[e];
    gw[((size_t)m * N + n) * P + (e - m * P)] = make_float2(v.x, -v.y);
  }
}

size_t smem_bytes(int M, int ny, int nx) {
  return sizeof(float2) * ((size_t)(M + 1) * ny * nx + (size_t)ny * ny +
                           (size_t)nx * nx);
}

template <typename T>
int launch_fwd(const void* db, const void* w0, const void* ay, const void* bx,
               const void* fay, const void* fbx, void* out, void* rec, int S,
               int M, int N, int ny, int nx, float neg_k1, float neg_sk1,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(M, ny, nx);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<T><<<N, kThreads, smem, stream>>>(
      static_cast<const T*>(db), static_cast<const float2*>(w0),
      static_cast<const float2*>(ay), static_cast<const float2*>(bx),
      static_cast<const float2*>(fay), static_cast<const float2*>(fbx),
      static_cast<float2*>(out), static_cast<T*>(rec), S, M, N, ny, nx,
      neg_k1, neg_sk1);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* db, const void* rec, const void* g, const void* ay,
               const void* bx, const void* fay, const void* fbx, void* gdb,
               void* gw, int S, int M, int N, int ny, int nx, float neg_k1,
               float neg_sk1, float sk1, cudaStream_t stream) {
  const size_t smem = smem_bytes(M, ny, nx);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<T><<<N, kThreads, smem, stream>>>(
      static_cast<const T*>(db), static_cast<const T*>(rec),
      static_cast<const float2*>(g), static_cast<const float2*>(ay),
      static_cast<const float2*>(bx), static_cast<const float2*>(fay),
      static_cast<const float2*>(fbx), static_cast<T*>(gdb),
      static_cast<float2*>(gw), S, M, N, ny, nx, neg_k1, neg_sk1, sk1);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (db, records and gdb).  fay/fbx may be
// null (no far field folded into the last step).  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int k1_fwd(int dtype, const void* db, const void* w0,
                      const void* ay, const void* bx, const void* fay,
                      const void* fbx, void* out, void* rec, int S, int M,
                      int N, int ny, int nx, float neg_k1, float neg_sk1,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(db, w0, ay, bx, fay, fbx, out, rec, S, M, N, ny,
                             nx, neg_k1, neg_sk1, st);
  return launch_fwd<__nv_bfloat16>(db, w0, ay, bx, fay, fbx, out, rec, S, M,
                                   N, ny, nx, neg_k1, neg_sk1, st);
}

extern "C" int k1_bwd(int dtype, const void* db, const void* rec,
                      const void* g, const void* ay, const void* bx,
                      const void* fay, const void* fbx, void* gdb, void* gw,
                      int S, int M, int N, int ny, int nx, float neg_k1,
                      float neg_sk1, float sk1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(db, rec, g, ay, bx, fay, fbx, gdb, gw, S, M, N,
                             ny, nx, neg_k1, neg_sk1, sk1, st);
  return launch_bwd<__nv_bfloat16>(db, rec, g, ay, bx, fay, fbx, gdb, gw, S,
                                   M, N, ny, nx, neg_k1, neg_sk1, sk1, st);
}
