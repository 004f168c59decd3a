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
// of the wave gradient.  The mode sum gt = sum_m a w is taken in f32, in
// mode order, and rounded once to the db dtype: no atomics, deterministic.
//
// What bounds it on the H100: bytes.  At the flagship (S=32, M=1, N=529,
// 72x72, f32) one sweep moves about 1.45 GB of db, records and waves
// forward (2.15 GB backward), 0.43 / 0.64 ms at 3.35 TB/s.  Its 31
// propagations and far field need about 11.7 GFLOP when the transforms are
// FFTs (0.17 ms of f32 CUDA-core work).
//
// Design: one block per (batch item, probe mode) (multislice_common.cuh).
// The block keeps its wave and a scratch plane in shared memory for the
// whole z scan, so the wavefield never leaves the SM between steps (the
// TPU kernel's one idea); device memory sees each record written once.
// The modes of a patch are independent in the forward; the backward needs
// their sum gt, so at M > 1 it launches the patch's M blocks as one
// thread-block cluster and sums through distributed shared memory
// (msdb::cross_mode_sum), at most 8 modes.  At M = 1 the block forms gt
// alone.  Plain f32 FMAs throughout: the f32 path is full f32 and bf16 is a
// storage type only.
//
// Two routes for the steps, chosen by the wrapper from the shape alone, as
// K4's (multislice_db.cu):
//   FFT   (route 1; ny and nx each n1 n2 with 2 <= n1 <= n2 <= 9, so 72 =
//         8 x 9): each step is msdb::fft_propagate, six passes of two-stage
//         transforms in shared memory at the FFT count of work; the forward
//         is K4f's sweep with the record stores, the backward runs P^T
//         (kStepPT) a step.  The mat slots hold the far field once a
//         launch; during the steps they hold the step's db planes (and in
//         the backward its record plane), copied in with cp.async while the
//         step before propagates, so the modulation reads shared memory.
//         169 KB at 72x72, forward and backward.
//   dense (route 0; any other shape): the folded per-axis matrices in the
//         mat slots, two 72-deep complex matmuls a step (76 GFLOP a sweep
//         at the flagship in the three-multiply form, 6.4 times the FFT
//         count); each thread owns four output rows of one column, so every
//         matrix element it loads feeds four complex multiply-adds.  166 KB
//         at 72x72.
//   global (route 2; a shape whose dense block passes the 227 KB of shared
//         memory, 88x88 and up): the dense route's kernels with the block's
//         two planes in a device-memory workspace (N M planes of 2 ny nx
//         complex) and the mats read where they lie (multislice_common.cuh).

#include "multislice_common.cuh"

namespace {

using namespace msdb;

// One block holds the wave (or cotangent), a scratch plane and the mat
// slots (and on the FFT route the table).
constexpr int kPlanes = 2;

// g, gw [M, N, P] complex in PyTorch's convention (the conjugate of
// JAX's cotangent); gdb [S, 2, N, P] in T.  ay/bx are the TRANSPOSED step
// mats (Py^T, Px), or with kFft the step's vectors hy/ny and hx/nx; fay/fbx
// the transposed far-field mats (Fy^T, Fx).
template <typename T, bool kFft, bool kGlobal = false>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const T* __restrict__ db, const T* __restrict__ rec,
               const float2* __restrict__ g, const float2* __restrict__ ay,
               const float2* __restrict__ bx, const float2* __restrict__ fay,
               const float2* __restrict__ fbx, T* __restrict__ gdb,
               float2* __restrict__ gw, int S, int M, int N, int ny, int nx,
               float neg_k1, float neg_sk1, float sk1,
               float2* __restrict__ ws) {
  extern __shared__ float2 smem[];
  const int P = ny * nx;
  const int Q = kFft ? ny * fft_row_stride(nx) : P;
  float2* a = kGlobal ? ws + (size_t)blockIdx.x * kPlanes * P : smem;
  float2* scr = a + Q;
  float2* may = scr + Q;
  float2* mbx = may + ny * ny;
  // The dense steps' mats: the slots, or on the global route in place.
  const float2* my = kGlobal ? ay : may;
  const float2* mx = kGlobal ? bx : mbx;
  const int n = blockIdx.x / M;
  const int m = blockIdx.x - n * M;
  const size_t wave_off = ((size_t)m * N + n) * P;

  // On the FFT route, after the far field, the slot region holds the
  // step's db planes and its record plane (stage).
  T* stage = reinterpret_cast<T*>(may);
  FftPlan plan;
  if constexpr (kFft) {
    plan = fft_plan(may + fft_slot_elems(2, ny, nx), ay, bx, ny, nx);
  }
  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    const float2 v = g[wave_off + e];
    a[e] = make_float2(v.x, -v.y);
  }
  if (fay != nullptr) {
    if constexpr (kGlobal) {
      __syncthreads();
      propagate(a, scr, fay, fbx, ny, nx);
    } else {
      copy_to_smem(may, fay, ny * ny);
      copy_to_smem(mbx, fbx, nx * nx);
      __syncthreads();
      propagate(a, scr, may, mbx, ny, nx);
    }
  }
  if constexpr (kFft) {
    stage_async(stage, db + ((size_t)(2 * S - 2) * N + n) * P, P);
    stage_async(stage + P, db + ((size_t)(2 * S - 1) * N + n) * P, P);
    stage_async(stage + 2 * P,
                rec + (((size_t)(S - 1) * M + m) * N + n) * P * 2, 2 * P);
    stage_wait();
  } else if constexpr (kGlobal) {
    __syncthreads();
  } else {
    copy_to_smem(may, ay, ny * ny);
    copy_to_smem(mbx, bx, nx * nx);
    __syncthreads();
  }

  for (int z = S - 1; z >= 0; --z) {
    const T* d = db + ((size_t)(2 * z) * N + n) * P;
    const T* b = db + ((size_t)(2 * z + 1) * N + n) * P;
    T* gd = gdb + ((size_t)(2 * z) * N + n) * P;
    T* gb = gdb + ((size_t)(2 * z + 1) * N + n) * P;
    const T* rz = rec + (((size_t)z * M + m) * N + n) * P * 2;
    if (z < S - 1) {
      if constexpr (kFft) {
        // The step's db and record planes arrive during the propagation.
        stage_async(stage, d, P);
        stage_async(stage + P, b, P);
        stage_async(stage + 2 * P, rz, 2 * P);
        fft_propagate<kStepPT>(a, scr, plan);
        stage_wait();
      } else {
        propagate(a, scr, my, mx, ny, nx);
      }
    }
    if constexpr (kFft) {
      d = stage;
      b = stage + P;
      rz = stage + 2 * P;
    }
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const float2 t = modulator(to_float(d[p]), to_float(b[p]), neg_k1,
                                 neg_sk1);
      const float2 wv = load_pair(rz + 2 * p);
      const float2 av = a[p];
      const float2 aw = cmul(av, wv);
      if (M == 1) {
        store_slice_grad(gd, gb, p, aw, t, neg_k1, sk1);
      } else {
        scr[p] = aw;
      }
      a[p] = cmul(av, t);
    }
    if (M == 1) {
      __syncthreads();
    } else {
      cross_mode_sum<T, kGlobal>(scr, d, b, gd, gb, P, M, m, neg_k1, neg_sk1,
                                 sk1, (size_t)kPlanes * P);
    }
  }

  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    const float2 v = a[e];
    gw[wave_off + e] = make_float2(v.x, -v.y);
  }
}

template <typename T>
int launch_fwd(int route, const void* db, const void* w0, const void* ay,
               const void* bx, const void* fay, const void* fbx, void* out,
               void* rec, int S, int M, int N, int ny, int nx, float neg_k1,
               float neg_sk1, void* ws, cudaStream_t stream) {
  decltype(&fwd_kernel<T, true>) kernel;
  size_t smem;
  if (!pick_route(route, kPlanes, ny, nx, &fwd_kernel<T, true>,
                  &fwd_kernel<T, true, true>,
                  &fwd_kernel<T, true, false, true>, &kernel, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(kernel, N, M, smem, false, kThreads, stream,
                static_cast<const T*>(db),
                static_cast<const float2*>(w0),
                static_cast<const float2*>(ay), static_cast<const float2*>(bx),
                static_cast<const float2*>(fay),
                static_cast<const float2*>(fbx), static_cast<float2*>(out),
                static_cast<T*>(rec), S, M, N, ny, nx, neg_k1, neg_sk1,
                static_cast<float2*>(ws));
}

template <typename T>
int launch_bwd(int route, const void* db, const void* rec, const void* g,
               const void* ay, const void* bx, const void* fay,
               const void* fbx, void* gdb, void* gw, int S, int M, int N,
               int ny, int nx, float neg_k1, float neg_sk1, float sk1,
               void* ws, cudaStream_t stream) {
  if (M > kMaxModes) return (int)cudaErrorInvalidValue;
  decltype(&bwd_kernel<T, false>) kernel;
  size_t smem;
  if (!pick_route(route, kPlanes, ny, nx, &bwd_kernel<T, false>,
                  &bwd_kernel<T, true>, &bwd_kernel<T, false, true>, &kernel,
                  &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(kernel, N, M, smem, true, kThreads, stream,
                static_cast<const T*>(db),
                static_cast<const T*>(rec), static_cast<const float2*>(g),
                static_cast<const float2*>(ay), static_cast<const float2*>(bx),
                static_cast<const float2*>(fay),
                static_cast<const float2*>(fbx), static_cast<T*>(gdb),
                static_cast<float2*>(gw), S, M, N, ny, nx, neg_k1, neg_sk1,
                sk1, static_cast<float2*>(ws));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (db, records and gdb).  route: 0 dense
// (ay, bx the folded step mats), 1 FFT (ay, bx the step's vectors hy/ny,
// hx/nx; refused for a shape without its radix split), 2 global (as dense;
// ws a workspace of N M kPlanes ny nx complex, else unused).  fay/fbx may be
// null (no far field folded into the last step).  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int k1_fwd(int dtype, int route, const void* db, const void* w0,
                      const void* ay, const void* bx, const void* fay,
                      const void* fbx, void* out, void* rec, int S, int M,
                      int N, int ny, int nx, float neg_k1, float neg_sk1,
                      void* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(route, db, w0, ay, bx, fay, fbx, out, rec, S, M,
                             N, ny, nx, neg_k1, neg_sk1, ws, st);
  return launch_fwd<__nv_bfloat16>(route, db, w0, ay, bx, fay, fbx, out, rec,
                                   S, M, N, ny, nx, neg_k1, neg_sk1, ws, st);
}

extern "C" int k1_bwd(int dtype, int route, const void* db, const void* rec,
                      const void* g, const void* ay, const void* bx,
                      const void* fay, const void* fbx, void* gdb, void* gw,
                      int S, int M, int N, int ny, int nx, float neg_k1,
                      float neg_sk1, float sk1, void* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(route, db, rec, g, ay, bx, fay, fbx, gdb, gw, S,
                             M, N, ny, nx, neg_k1, neg_sk1, sk1, ws, st);
  return launch_bwd<__nv_bfloat16>(route, db, rec, g, ay, bx, fay, fbx, gdb,
                                   gw, S, M, N, ny, nx, neg_k1, neg_sk1, sk1,
                                   ws, st);
}
