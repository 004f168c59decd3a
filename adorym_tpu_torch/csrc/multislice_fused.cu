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
// matrix per axis as in multislice_db_stored.cu.  The backward runs the
// JAX-convention (unconjugated) cotangent sweep of _bwd_kernel: the
// transpose of a step is F_y (H o (G_y a G_x)) F_x, then
//   gt_z = sum_m a_m rec_z,m        a_m <- a_m t_z,
// and the conversion from and to PyTorch's conjugate convention happens at
// the load of the incoming gradient and at the stores of gt and gw.  The
// mode sum is taken in mode order, in f32: no atomics.  All arithmetic and
// the records are f32 in every mode: the JAX kernel's bf16 flag lowers
// only the TPU's dot precision, which has no counterpart here.
//
// What bounds it on the H100: bytes.  At the real_imag flagship (S=32, M=1,
// N=529, 72x72) one sweep moves 1.45 GB (forward: t, records, waves) or
// 2.15 GB (backward) of device memory, 0.43 / 0.64 ms at 3.35 TB/s.  Its 31
// propagations of 529 patches need about 11.5 GFLOP when the transforms
// are FFTs (0.17 ms of f32 CUDA-core work).
//
// Two routes for the steps, chosen by the wrapper from the shape alone
// (cuda_multislice_fused.k5_route), as K1's and K4's:
//   FFT   (route 1; ny and nx each n1 n2 with 2 <= n1 <= n2 <= 9, so 72 =
//         8 x 9): one block per (batch item, probe mode), blockIdx.x = n M
//         + m, as K1 and K4 (multislice_common.cuh).  Each step is
//         msdb::fft_propagate2d, 7 passes of two-stage transforms in shared
//         memory at the FFT count of work, with the step table (H, rows
//         in the y axis's stage order, built once by the wrapper) in
//         shared memory, or read through L2 where it does not fit beside
//         the block's planes.  The next step's t plane (and in the backward
//         its record plane) is copied into shared memory with cp.async while
//         the step before propagates, so the modulation reads shared memory.
//         The backward launches a patch's M blocks as one thread-block
//         cluster and sums gt over the modes through distributed shared
//         memory (cross_mode_sum_t), at most 8 modes.  At 72x72 a forward
//         block takes 168,192 bytes, a backward block 209,664.
//   dense (route 0; any other shape): one block per batch item keeps its M
//         waves, one scratch plane and the DFT matrix (one when ny == nx) in
//         shared memory for the whole z scan (124 KB at M=1, 72x72; at most
//         3 modes there).  H is read from device memory, where L2 keeps it
//         for all blocks.  Each propagation is four 72-deep complex matmul
//         passes (147 GFLOP a sweep at the flagship in the three-multiply
//         form, 13 times the FFT count); each thread owns four output rows
//         of one column.  G is applied from F by conjugating on the fly and
//         scaling by 1/n at the store, and H at the store of the forward y
//         pass, so a propagation needs no extra pass over the plane.
//   global (route 2; a shape whose dense block passes the 227 KB of shared
//         memory, e.g. 128x128, or 96x96 at 3 modes): the dense route's
//         kernels with the block's M + 1 planes in a device-memory
//         workspace (N (M + 1) ny nx complex) and the DFT matrices read
//         where they lie, as K1's and K4's global route
//         (multislice_common.cuh).

#include "multislice_common.cuh"

namespace {

using namespace msdb;

// Dynamic shared memory one block may use on Hopper.
constexpr size_t kMaxSmemBytes = 232448;

__device__ __forceinline__ float2 conj2(float2 a) {
  return make_float2(a.x, -a.y);
}

// -- The dense route ----------------------------------------------------------

// C = scale * op(A) op(B), then elementwise times H when H is not null.
// Row-major complex matrices: A is R x K and B is K x Cn in shared memory,
// C is R x Cn in shared memory, H is R x Cn in device memory; op conjugates
// when its flag is set.  C must alias neither A nor B.
template <bool CONJ_A, bool CONJ_B>
__device__ void dense_cmatmul(const float2* __restrict__ A,
                              const float2* __restrict__ B,
                              float2* __restrict__ C, int R, int K, int Cn,
                              float scale, const float2* __restrict__ H) {
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
__device__ void dense_propagate(float2* w, float2* scr, const float2* fy,
                                const float2* fx, const float2* __restrict__ H,
                                int ny, int nx) {
  const float sx = 1.f / nx, sy = 1.f / ny;
  dense_cmatmul<false, INVERSE_FIRST>(w, fx, scr, ny, nx, nx,
                                      INVERSE_FIRST ? sx : 1.f, nullptr);
  __syncthreads();
  dense_cmatmul<INVERSE_FIRST, false>(fy, scr, w, ny, ny, nx,
                                      INVERSE_FIRST ? sy : 1.f, H);
  __syncthreads();
  dense_cmatmul<false, !INVERSE_FIRST>(w, fx, scr, ny, nx, nx,
                                       INVERSE_FIRST ? 1.f : sx, nullptr);
  __syncthreads();
  dense_cmatmul<!INVERSE_FIRST, false>(fy, scr, w, ny, ny, nx,
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
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
    dense_fwd_kernel(const float2* __restrict__ t,
                     const float2* __restrict__ w0,
                     const float2* __restrict__ fy,
                     const float2* __restrict__ fx,
                     const float2* __restrict__ H, float2* __restrict__ out,
                     float2* __restrict__ rec, int S, int M, int N, int ny,
                     int nx, float2* __restrict__ ws) {
  extern __shared__ float2 smem[];
  const int P = ny * nx;
  const int n = blockIdx.x;
  float2* w = kGlobal ? ws + (size_t)n * (M + 1) * P : smem;
  float2* scr = w + M * P;
  float2* slots = scr + P;  // the matrices' (not on the global route)

  for (int e = threadIdx.x; e < M * P; e += blockDim.x) {
    const int m = e / P;
    w[e] = w0[((size_t)m * N + n) * P + (e - m * P)];
  }
  const float2* sfx = kGlobal ? fx : load_mats(slots, fy, fx, ny, nx);
  const float2* sfy = kGlobal ? fy : slots;
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
      dense_propagate<false>(w + m * P, scr, sfy, sfx, H, ny, nx);
    }
  }

  for (int e = threadIdx.x; e < M * P; e += blockDim.x) {
    const int m = e / P;
    out[((size_t)m * N + n) * P + (e - m * P)] = w[e];
  }
}

// g, gw [M, N, P] and gt [S, N, P] complex64 in PyTorch's convention (the
// conjugates of JAX's cotangents).
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
    dense_bwd_kernel(const float2* __restrict__ t,
                     const float2* __restrict__ rec,
                     const float2* __restrict__ g,
                     const float2* __restrict__ fy,
                     const float2* __restrict__ fx,
                     const float2* __restrict__ H, float2* __restrict__ gt,
                     float2* __restrict__ gw, int S, int M, int N, int ny,
                     int nx, float2* __restrict__ ws) {
  extern __shared__ float2 smem[];
  const int P = ny * nx;
  const int n = blockIdx.x;
  float2* a = kGlobal ? ws + (size_t)n * (M + 1) * P : smem;
  float2* scr = a + M * P;
  float2* slots = scr + P;  // the matrices' (not on the global route)

  for (int e = threadIdx.x; e < M * P; e += blockDim.x) {
    const int m = e / P;
    a[e] = conj2(g[((size_t)m * N + n) * P + (e - m * P)]);
  }
  const float2* sfx = kGlobal ? fx : load_mats(slots, fy, fx, ny, nx);
  const float2* sfy = kGlobal ? fy : slots;
  __syncthreads();

  for (int z = S - 1; z >= 0; --z) {
    if (z < S - 1) {
      for (int m = 0; m < M; ++m) {
        dense_propagate<true>(a + m * P, scr, sfy, sfx, H, ny, nx);
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

size_t dense_smem_bytes(int M, int ny, int nx) {
  return sizeof(float2) * ((size_t)(M + 1) * ny * nx + (size_t)ny * ny +
                           (nx == ny ? 0 : (size_t)nx * nx));
}

// -- The FFT route ------------------------------------------------------------

// Dynamic shared memory of an FFT-route block: the plane and its scratch
// plane (odd row stride), `staged` planes copied in during each step (t;
// in the backward also the record), the roots of both axes and, when
// `table`, the step table.
size_t fft2d_smem_bytes(int staged, int ny, int nx, bool table) {
  return sizeof(float2) * (2 * (size_t)ny * fft_row_stride(nx) +
                           (size_t)(staged + (table ? 1 : 0)) * ny * nx +
                           ny + nx);
}

// The step table of an FFT-route block: copied into shared memory at `stab`
// with kTable, else read in place (through L2).
template <bool kTable>
__device__ __forceinline__ const float2* load_table(float2* stab,
                                                    const float2* tab, int P) {
  if constexpr (kTable) {
    stage_async(stab, tab, P);
    return stab;
  }
  return tab;
}

// t [S, N, P], w0 and out [M, N, P], rec [S, M, N, P], all complex64; tab
// [ny, nx] the step table.  One block per (n, m).
template <bool kTable>
__global__ void __launch_bounds__(kThreads)
    fft_fwd_kernel(const float2* __restrict__ t, const float2* __restrict__ w0,
                   const float2* __restrict__ tab, float2* __restrict__ out,
                   float2* __restrict__ rec, int S, int M, int N, int ny,
                   int nx) {
  extern __shared__ float2 smem[];
  const int P = ny * nx;
  const int Q = ny * fft_row_stride(nx);
  float2* w = smem;
  float2* scr = w + Q;
  float2* stage = scr + Q;
  float2* roots = stage + P;
  const int n = blockIdx.x / M;
  const int m = blockIdx.x - n * M;
  const size_t wave_off = ((size_t)m * N + n) * P;

  copy_to_smem(w, w0 + wave_off, P);
  stage_async(stage, t + (size_t)n * P, P);
  const float2* h2 = load_table<kTable>(roots + ny + nx, tab, P);
  const FftPlan plan = fft_plan2d(roots, ny, nx);
  stage_wait();

  // The wave entering the modulation: the loaded one, then each step's
  // result, which fft_propagate2d leaves in scr.
  const float2* cur = w;
  for (int z = 0; z < S; ++z) {
    float2* rz = rec + (((size_t)z * M + m) * N + n) * P;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const float2 wv = cur[p];
      rz[p] = wv;
      w[p] = cmul(wv, stage[p]);
    }
    __syncthreads();
    if (z == S - 1) break;
    // The next step's t arrives during the propagation.
    stage_async(stage, t + ((size_t)(z + 1) * N + n) * P, P);
    fft_propagate2d<kStepP>(w, scr, plan, h2);
    stage_wait();
    cur = scr;
  }

  for (int e = threadIdx.x; e < P; e += blockDim.x) out[wave_off + e] = w[e];
}

// The cross-mode sum of one backward step, for M > 1: every block of the
// patch's cluster has put its mode's a_m rec_m into `part` (its scratch
// plane).  After the cluster barrier, block m sums all M planes for its
// share of the pixels, reading the other blocks' shared memory in place, in
// mode order and in f32, and stores the conjugate (PyTorch's convention) to
// gt; the second barrier keeps every plane alive until all have read it.
// msdb::cross_mode_sum's layout, with the complex gt of K5.
__device__ void cross_mode_sum_t(float2* part, float2* gt, int P, int M,
                                 int m) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = (P + M - 1) / M;
  const int p0 = m * share;
  const int p1 = min(P, p0 + share);
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    float2 sum = make_float2(0.f, 0.f);
    for (int r = 0; r < M; ++r) {
      const float2 v = cluster.map_shared_rank(part, r)[p];
      sum.x += v.x;
      sum.y += v.y;
    }
    gt[p] = conj2(sum);
  }
  cluster.sync();
}

// g, gw [M, N, P] and gt [S, N, P] complex64 in PyTorch's convention (the
// conjugates of JAX's cotangents); tab the step table.  One block per (n, m),
// the M blocks of a patch one cluster.
template <bool kTable>
__global__ void __launch_bounds__(kThreads)
    fft_bwd_kernel(const float2* __restrict__ t, const float2* __restrict__ rec,
                   const float2* __restrict__ g, const float2* __restrict__ tab,
                   float2* __restrict__ gt, float2* __restrict__ gw, int S,
                   int M, int N, int ny, int nx) {
  extern __shared__ float2 smem[];
  const int P = ny * nx;
  const int Q = ny * fft_row_stride(nx);
  float2* a = smem;
  float2* scr = a + Q;
  float2* st = scr + Q;  // the step's t plane
  float2* sr = st + P;   // the step's record plane
  float2* roots = sr + P;
  const int n = blockIdx.x / M;
  const int m = blockIdx.x - n * M;
  const size_t wave_off = ((size_t)m * N + n) * P;

  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    a[e] = conj2(g[wave_off + e]);
  }
  stage_async(st, t + ((size_t)(S - 1) * N + n) * P, P);
  stage_async(sr, rec + (((size_t)(S - 1) * M + m) * N + n) * P, P);
  const float2* h2 = load_table<kTable>(roots + ny + nx, tab, P);
  const FftPlan plan = fft_plan2d(roots, ny, nx);
  stage_wait();

  // The cotangent entering the step's modulation: a at the last step, then
  // each P^T's result, which fft_propagate2d leaves in scr.
  const float2* cur = a;
  for (int z = S - 1; z >= 0; --z) {
    if (z < S - 1) {
      // The step's t and record planes arrive during the propagation.
      stage_async(st, t + ((size_t)z * N + n) * P, P);
      stage_async(sr, rec + (((size_t)z * M + m) * N + n) * P, P);
      fft_propagate2d<kStepPT>(a, scr, plan, h2);
      stage_wait();
      cur = scr;
    }
    float2* gtz = gt + ((size_t)z * N + n) * P;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const float2 av = cur[p];
      const float2 aw = cmul(av, sr[p]);
      if (M == 1) {
        gtz[p] = conj2(aw);
      } else {
        scr[p] = aw;
      }
      a[p] = cmul(av, st[p]);
    }
    if (M == 1) {
      __syncthreads();
    } else {
      cross_mode_sum_t(scr, gtz, P, M, m);
    }
  }

  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    gw[wave_off + e] = conj2(a[e]);
  }
}

// Launches a dense-route kernel (kGlobal: the global route's) over N
// blocks.  Returns the CUDA error code.
template <typename K, typename... Args>
int launch_dense(K kernel, bool global, int M, int N, int ny, int nx,
                 cudaStream_t stream, Args... args) {
  const size_t smem = global ? 0 : dense_smem_bytes(M, ny, nx);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<N, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The FFT-route kernel of a block holding `staged` planes, with its shared
// memory: the step table in shared memory where it fits, else through L2.
// False when the shape has no radix split.
template <typename K>
bool pick_fft(int staged, int ny, int nx, K with_table, K without_table,
              K* kernel, size_t* smem) {
  if (fft_radix(ny) == 0 || fft_radix(nx) == 0) return false;
  *smem = fft2d_smem_bytes(staged, ny, nx, true);
  *kernel = with_table;
  if (*smem > kMaxSmemBytes) {
    *smem = fft2d_smem_bytes(staged, ny, nx, false);
    *kernel = without_table;
  }
  return true;
}

}  // namespace

// route: 0 dense (fy, fx the DFT matrices, fx may equal fy; h the transfer
// function H), 1 FFT (fy, fx unused; h the step table; refused for a shape
// without its radix split), 2 global (as dense; ws a workspace of N (M + 1)
// ny nx complex, else unused).  Returns the CUDA error code of the launch
// (0 on success).
extern "C" int k5_fwd(int route, const void* t, const void* w0,
                      const void* fy, const void* fx, const void* h,
                      void* out, void* rec, int S, int M, int N, int ny,
                      int nx, void* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteDense || route == kRouteGlobal) {
    const bool global = route == kRouteGlobal;
    return launch_dense(
        global ? &dense_fwd_kernel<true> : &dense_fwd_kernel<false>, global,
        M, N, ny, nx, st, static_cast<const float2*>(t),
        static_cast<const float2*>(w0), static_cast<const float2*>(fy),
        static_cast<const float2*>(fx), static_cast<const float2*>(h),
        static_cast<float2*>(out), static_cast<float2*>(rec), S, M, N, ny,
        nx, static_cast<float2*>(ws));
  }
  decltype(&fft_fwd_kernel<true>) kernel;
  size_t smem;
  if (route != kRouteFft ||
      !pick_fft(1, ny, nx, &fft_fwd_kernel<true>, &fft_fwd_kernel<false>,
                &kernel, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(kernel, N, M, smem, false, kThreads, st,
                static_cast<const float2*>(t),
                static_cast<const float2*>(w0), static_cast<const float2*>(h),
                static_cast<float2*>(out), static_cast<float2*>(rec), S, M, N,
                ny, nx);
}

extern "C" int k5_bwd(int route, const void* t, const void* rec,
                      const void* g, const void* fy, const void* fx,
                      const void* h, void* gt, void* gw, int S, int M, int N,
                      int ny, int nx, void* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteDense || route == kRouteGlobal) {
    const bool global = route == kRouteGlobal;
    return launch_dense(
        global ? &dense_bwd_kernel<true> : &dense_bwd_kernel<false>, global,
        M, N, ny, nx, st, static_cast<const float2*>(t),
        static_cast<const float2*>(rec), static_cast<const float2*>(g),
        static_cast<const float2*>(fy), static_cast<const float2*>(fx),
        static_cast<const float2*>(h), static_cast<float2*>(gt),
        static_cast<float2*>(gw), S, M, N, ny, nx, static_cast<float2*>(ws));
  }
  if (M > kMaxModes) return (int)cudaErrorInvalidValue;
  decltype(&fft_bwd_kernel<true>) kernel;
  size_t smem;
  if (route != kRouteFft ||
      !pick_fft(2, ny, nx, &fft_bwd_kernel<true>, &fft_bwd_kernel<false>,
                &kernel, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(kernel, N, M, smem, true, kThreads, st,
                static_cast<const float2*>(t),
                static_cast<const float2*>(rec), static_cast<const float2*>(g),
                static_cast<const float2*>(h), static_cast<float2*>(gt),
                static_cast<float2*>(gw), S, M, N, ny, nx);
}
