// Multislice propagation through precomputed slice transmissions with a
// general transfer function: forward (k5_fwd) and backward (k5_bwd) sweeps
// over the z steps.
//
// Replaces the Pallas kernels of adorym_tpu/ops/pallas_multislice.py:
//   _fwd_kernel (:184, launched by _call_fwd_inner :673) and
//   _bwd_kernel (:222, launched by _call_bwd_inner :723),
// the custom-VJP pair behind multislice_fused (:774).
//
// Math (per batch item n, probe mode m, step z = 0..S-1; t is complex):
//   rec_z = w                                      (recorded in f32)
//   w     = G_y (H o (F_y (w t_z) F_x)) G_x        z < S-1
//   out   = w t_{S-1}
// F is the DFT matrix exp(-2 pi i k l / n), G = conj(F) / n its inverse,
// both symmetric; H is any [ny, nx] transfer function (unshifted), not
// necessarily separable, so the two transforms cannot be folded into one
// matrix per axis as in multislice_db_stored.cu: each propagation is four
// matmul passes (x and y forward, x and y inverse) with H applied between.
// The backward runs the JAX-convention (unconjugated) cotangent sweep of
// _bwd_kernel: the transpose of a step is F_y (H o (G_y a G_x)) F_x, then
//   gt_z = sum_m a_m rec_z,m        a_m <- a_m t_z,
// and the conversion from and to PyTorch's conjugate convention happens at
// the load of the incoming gradient and at the stores of gt and gw.  The
// mode sum is taken inside the block in mode order: no atomics.  All
// arithmetic and the records are f32 in every mode: the JAX kernel's bf16
// flag lowers only the TPU's dot precision, which has no counterpart here.
//
// What bounds it on the H100: bytes.  At the real_imag flagship (S=32, M=1,
// N=529, 72x72) one sweep moves 1.45 GB (forward: t, records, waves) or
// 2.15 GB (backward) of device memory, 0.43 / 0.64 ms at 3.35 TB/s.  Its 31
// propagations of 529 patches need about 11.5 GFLOP when the transforms
// are FFTs (0.17 ms of f32 CUDA-core work).  The four 72-deep complex
// matmul passes this kernel runs instead do 147 GFLOP in the three-multiply
// form, 2.2 ms at the f32 peak: the algorithm, not the function, puts this
// design far above its bound.
//
// Design: the structure of multislice_db_stored.cu.  One block per batch
// item keeps its M waves, one scratch plane and the DFT matrix (one when
// ny == nx) in shared memory for the whole z scan: 124 KB at M=1, 72x72.
// H (41 KB) is read from device memory, where L2 keeps it for all blocks.
// Each matmul pass reads shared memory only; each thread owns four output
// rows of one column.  G is applied from F by conjugating on the fly and
// scaling by 1/n at the store, and H is applied at the store of the
// forward y pass, so a propagation needs no extra pass over the plane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRowsPerThread = 4;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conj2(float2 a) {
  return make_float2(a.x, -a.y);
}

// C = scale * op(A) op(B), then elementwise times H when H is not null.
// Row-major complex matrices: A is R x K and B is K x Cn in shared memory,
// C is R x Cn in shared memory, H is R x Cn in device memory; op conjugates
// when its flag is set.  C must alias neither A nor B.
template <bool CONJ_A, bool CONJ_B>
__device__ void cmatmul(const float2* __restrict__ A,
                        const float2* __restrict__ B, float2* __restrict__ C,
                        int R, int K, int Cn, float scale,
                        const float2* __restrict__ H) {
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
      if (CONJ_B) b.y = -b.y;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        float2 a = rows[i][k];
        if (CONJ_A) a.y = -a.y;
        acc_r[i] = fmaf(a.x, b.x, acc_r[i]);
        acc_r[i] = fmaf(-a.y, b.y, acc_r[i]);
        acc_i[i] = fmaf(a.x, b.y, acc_i[i]);
        acc_i[i] = fmaf(a.y, b.x, acc_i[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = r0 + i;
      if (r < R) {
        float2 v = make_float2(acc_r[i] * scale, acc_i[i] * scale);
        if (H != nullptr) v = cmul(v, H[r * Cn + c]);
        C[r * Cn + c] = v;
      }
    }
  }
}

// One step of one ny x nx plane through the scratch plane.  INVERSE_FIRST
// false: w <- G_y (H o (F_y w F_x)) G_x (the forward step); true:
// w <- F_y (H o (G_y w G_x)) F_x (its transpose).  Ends with a barrier.
template <bool INVERSE_FIRST>
__device__ void propagate(float2* w, float2* scr, const float2* fy,
                          const float2* fx, const float2* __restrict__ H,
                          int ny, int nx) {
  const float sx = 1.f / nx, sy = 1.f / ny;
  cmatmul<false, INVERSE_FIRST>(w, fx, scr, ny, nx, nx,
                                INVERSE_FIRST ? sx : 1.f, nullptr);
  __syncthreads();
  cmatmul<INVERSE_FIRST, false>(fy, scr, w, ny, ny, nx,
                                INVERSE_FIRST ? sy : 1.f, H);
  __syncthreads();
  cmatmul<false, !INVERSE_FIRST>(w, fx, scr, ny, nx, nx,
                                 INVERSE_FIRST ? 1.f : sx, nullptr);
  __syncthreads();
  cmatmul<!INVERSE_FIRST, false>(fy, scr, w, ny, ny, nx,
                                 INVERSE_FIRST ? 1.f : sy, nullptr);
  __syncthreads();
}

// Shared memory: the M planes, the scratch plane, F_y and (when nx != ny)
// F_x.  Returns the F_x pointer.
__device__ const float2* load_mats(float2* sfy, const float2* fy,
                                   const float2* fx, int ny, int nx) {
  for (int e = threadIdx.x; e < ny * ny; e += blockDim.x) sfy[e] = fy[e];
  if (nx == ny) return sfy;
  float2* sfx = sfy + ny * ny;
  for (int e = threadIdx.x; e < nx * nx; e += blockDim.x) sfx[e] = fx[e];
  return sfx;
}

// t [S, N, P], w0 and out [M, N, P], rec [S, M, N, P], all complex64;
// fy [ny, ny], fx [nx, nx] DFT matrices; H [ny, nx].
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const float2* __restrict__ t, const float2* __restrict__ w0,
               const float2* __restrict__ fy, const float2* __restrict__ fx,
               const float2* __restrict__ H, float2* __restrict__ out,
               float2* __restrict__ rec, int S, int M, int N, int ny,
               int nx) {
  extern __shared__ float2 smem[];
  const int P = ny * nx;
  float2* w = smem;
  float2* scr = w + M * P;
  float2* sfy = scr + P;
  const int n = blockIdx.x;

  for (int e = threadIdx.x; e < M * P; e += blockDim.x) {
    const int m = e / P;
    w[e] = w0[((size_t)m * N + n) * P + (e - m * P)];
  }
  const float2* sfx = load_mats(sfy, fy, fx, ny, nx);
  __syncthreads();

  for (int z = 0; z < S; ++z) {
    const float2* tz = t + ((size_t)z * N + n) * P;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const float2 tv = tz[p];
      for (int m = 0; m < M; ++m) {
        const float2 wv = w[m * P + p];
        rec[(((size_t)z * M + m) * N + n) * P + p] = wv;
        w[m * P + p] = cmul(wv, tv);
      }
    }
    __syncthreads();
    if (z == S - 1) break;
    for (int m = 0; m < M; ++m) {
      propagate<false>(w + m * P, scr, sfy, sfx, H, ny, nx);
    }
  }

  for (int e = threadIdx.x; e < M * P; e += blockDim.x) {
    const int m = e / P;
    out[((size_t)m * N + n) * P + (e - m * P)] = w[e];
  }
}

// g, gw [M, N, P] and gt [S, N, P] complex64 in PyTorch's convention (the
// conjugates of JAX's cotangents).
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const float2* __restrict__ t, const float2* __restrict__ rec,
               const float2* __restrict__ g, const float2* __restrict__ fy,
               const float2* __restrict__ fx, const float2* __restrict__ H,
               float2* __restrict__ gt, float2* __restrict__ gw, int S,
               int M, int N, int ny, int nx) {
  extern __shared__ float2 smem[];
  const int P = ny * nx;
  float2* a = smem;
  float2* scr = a + M * P;
  float2* sfy = scr + P;
  const int n = blockIdx.x;

  for (int e = threadIdx.x; e < M * P; e += blockDim.x) {
    const int m = e / P;
    a[e] = conj2(g[((size_t)m * N + n) * P + (e - m * P)]);
  }
  const float2* sfx = load_mats(sfy, fy, fx, ny, nx);
  __syncthreads();

  for (int z = S - 1; z >= 0; --z) {
    if (z < S - 1) {
      for (int m = 0; m < M; ++m) {
        propagate<true>(a + m * P, scr, sfy, sfx, H, ny, nx);
      }
    }
    const float2* tz = t + ((size_t)z * N + n) * P;
    float2* gtz = gt + ((size_t)z * N + n) * P;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const float2 tv = tz[p];
      float2 sum = make_float2(0.f, 0.f);
      for (int m = 0; m < M; ++m) {
        const float2 av = a[m * P + p];
        const float2 wv = rec[(((size_t)z * M + m) * N + n) * P + p];
        sum.x += av.x * wv.x - av.y * wv.y;
        sum.y += av.x * wv.y + av.y * wv.x;
        a[m * P + p] = cmul(av, tv);
      }
      gtz[p] = conj2(sum);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < M * P; e += blockDim.x) {
    const int m = e / P;
    gw[((size_t)m * N + n) * P + (e - m * P)] = conj2(a[e]);
  }
}

size_t smem_bytes(int M, int ny, int nx) {
  return sizeof(float2) * ((size_t)(M + 1) * ny * nx + (size_t)ny * ny +
                           (nx == ny ? 0 : (size_t)nx * nx));
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).  fx may equal
// fy (square planes share one matrix in shared memory).
extern "C" int k5_fwd(const void* t, const void* w0, const void* fy,
                      const void* fx, const void* h, void* out, void* rec,
                      int S, int M, int N, int ny, int nx, void* stream) {
  const size_t smem = smem_bytes(M, ny, nx);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(t), static_cast<const float2*>(w0),
      static_cast<const float2*>(fy), static_cast<const float2*>(fx),
      static_cast<const float2*>(h), static_cast<float2*>(out),
      static_cast<float2*>(rec), S, M, N, ny, nx);
  return (int)cudaGetLastError();
}

extern "C" int k5_bwd(const void* t, const void* rec, const void* g,
                      const void* fy, const void* fx, const void* h,
                      void* gt, void* gw, int S, int M, int N, int ny, int nx,
                      void* stream) {
  const size_t smem = smem_bytes(M, ny, nx);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(t), static_cast<const float2*>(rec),
      static_cast<const float2*>(g), static_cast<const float2*>(fy),
      static_cast<const float2*>(fx), static_cast<const float2*>(h),
      static_cast<float2*>(gt), static_cast<float2*>(gw), S, M, N, ny, nx);
  return (int)cudaGetLastError();
}
