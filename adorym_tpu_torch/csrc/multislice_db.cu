// Multislice propagation with invertible steps, delta/beta object: forward
// (k4_fwd) and backward (k4_bwd) sweeps over the z steps that store nothing
// step-sized.
//
// Replaces the Pallas kernels of adorym_tpu/ops/pallas_multislice.py:
//   _fwd_db_kernel (:294, launched by _call_fwd_db :827) and
//   _bwd_db_kernel (:495, launched by _call_bwd_db :874),
// the custom-VJP pair behind multislice_db_packed (:941).
//
// Math: the forward is k1_fwd's (multislice_db_stored.cu) without records.
// The backward rebuilds each step's wave instead of reading a record: the
// paraxial step P = G diag(h) F is unitary, so P^-1 = conj(P)^T, and the
// transmission never vanishes, so with v the post-modulation wave
//   v_{S-1} = out, or F^-1 out with the far field (the exact inverse mats:
//            the unnormalised Fraunhofer pair is not unitary),
//   a      = g, or F^T g,
// and for z = S-1 .. 0:
//   z < S-1:  a <- P^T a,   v <- P^-1 v
//   w    = v (1/t_z),  1/t = exp(+k1 b) exp(+i s k1 d)  (no division)
//   gt   = sum_m a_m w_m;  gb = -k1 Re(gt t), gd = s k1 Im(gt t)
//   a   <- a t_z,  v <- w.
// Finally gw = a.  JAX's unconjugated convention inside, PyTorch's at the
// load of g and the store of gw, as in k1_bwd.  f32 roundoff in the rebuilt
// waves grows by up to exp(k1 b) per step (_bwd_db_kernel's accuracy note).
//
// What bounds it on the H100: operations.  At the multi-mode chunk (S=256,
// M=3, N=529, 72x72, f32) the forward moves 5.75 GB (db, w0, out) against
// 285 GFLOP of FFT-counted propagations (1.72 ms of bytes, 4.25 ms of f32
// work at 67 TFLOP/s); the backward moves 11.4 GB against 582 GFLOP (two
// propagations per step; 3.41 ms against 8.69 ms).
//
// Design: K1's (multislice_common.cuh): one block per (batch item, probe
// mode), the forward k1_fwd's sweep with the record stores compiled out.
// The backward block keeps its mode's cotangent a, its rebuilt wave v and a
// scratch plane.  The far field enters once, as dense products in the two
// mat slots: at the last forward step, and at the backward's start (F^T for
// a, then the exact inverse for v).  At M > 1 the M blocks of a patch form a
// thread-block cluster and sum gt through distributed shared memory in
// mode order (msdb::cross_mode_sum).
//
// Two routes for the steps, chosen by the wrapper from the shape alone:
//   FFT   (route 1; ny and nx each n1 n2 with 2 <= n1 <= n2 <= 9, so 72 =
//         8 x 9): each step is msdb::fft_propagate, six passes of two-stage
//         transforms in shared memory, which do the FFT count of work the
//         bound uses; the steps' h vectors and the roots of unity sit beside
//         the mat slots (212 KB for the backward at 72x72).  The mat slots
//         hold the far field once a launch; during the steps they hold the
//         next step's db planes, copied in (cp.async) while the step before
//         propagates, and in the backward also v's scratch plane: the
//         backward propagates a and v in the same passes.
//   dense (route 0; any other shape): the folded step mats in the mat
//         slots, two 72-deep complex matmuls per propagation, about 6.4
//         times the FFT count; the backward serves a with the transposed
//         mats (Py^T, Px) and v with the same conjugated on load, since
//         P^-1 = conj(P^T) (207 KB at 72x72).
//   global (route 2; a shape whose dense block passes the 227 KB of shared
//         memory, 80x80 and up for the backward): the dense route's kernels
//         with the block's planes (two forward, three backward) in a
//         device-memory workspace and the mats read where they lie
//         (multislice_common.cuh).

#include "multislice_common.cuh"

namespace {

using namespace msdb;

constexpr int kFwdPlanes = 2;
constexpr int kBwdPlanes = 3;

// db [S, 2, N, P]; out, g, gw [M, N, P] complex (g and gw in PyTorch's
// convention); gdb [S, 2, N, P] in T.  ay/bx: the TRANSPOSED step mats
// (Py^T, Px), or with kFft the step's vectors hy/ny and hx/nx.  fay/fbx:
// the transposed far-field mats (Fy^T, Fx); iay/ibx: the far field's exact
// inverse in the orientation of the forward (Fy^-1, (Fx^-1)^T).  The
// far-field pointers are all null or all set.
template <typename T, bool kFft, bool kGlobal = false>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const T* __restrict__ db, const float2* __restrict__ out,
               const float2* __restrict__ g, const float2* __restrict__ ay,
               const float2* __restrict__ bx, const float2* __restrict__ fay,
               const float2* __restrict__ fbx,
               const float2* __restrict__ iay,
               const float2* __restrict__ ibx, T* __restrict__ gdb,
               float2* __restrict__ gw, int S, int M, int N, int ny, int nx,
               float neg_k1, float neg_sk1, float sk1,
               float2* __restrict__ ws) {
  extern __shared__ float2 smem[];
  const int P = ny * nx;
  const int Q = kFft ? ny * fft_row_stride(nx) : P;
  float2* a = kGlobal ? ws + (size_t)blockIdx.x * kBwdPlanes * P : smem;
  float2* v = a + Q;
  float2* scr = v + Q;
  float2* may = scr + Q;
  float2* mbx = may + ny * ny;
  // The dense steps' mats: the slots, or on the global route in place.
  const float2* my = kGlobal ? ay : may;
  const float2* mx = kGlobal ? bx : mbx;
  const int n = blockIdx.x / M;
  const int m = blockIdx.x - n * M;
  const size_t wave_off = ((size_t)m * N + n) * P;

  // On the FFT route, after the far field, the slot region holds v's
  // scratch plane (at may) and the step's db planes (stage).
  T* stage = reinterpret_cast<T*>(may + Q);
  FftPlan plan;
  if constexpr (kFft) {
    plan = fft_plan(may + fft_slot_elems(3, ny, nx), ay, bx, ny, nx);
  }
  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    const float2 ge = g[wave_off + e];
    a[e] = make_float2(ge.x, -ge.y);
    v[e] = out[wave_off + e];
  }
  if (fay != nullptr) {
    if constexpr (kGlobal) {
      __syncthreads();
      propagate(a, scr, fay, fbx, ny, nx);
      propagate(v, scr, iay, ibx, ny, nx);
    } else {
      copy_to_smem(may, fay, ny * ny);
      copy_to_smem(mbx, fbx, nx * nx);
      __syncthreads();
      propagate(a, scr, may, mbx, ny, nx);
      copy_to_smem(may, iay, ny * ny);
      copy_to_smem(mbx, ibx, nx * nx);
      __syncthreads();
      propagate(v, scr, may, mbx, ny, nx);
    }
  }
  if constexpr (kFft) {
    stage_async(stage, db + ((size_t)(2 * S - 2) * N + n) * P, P);
    stage_async(stage + P, db + ((size_t)(2 * S - 1) * N + n) * P, P);
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
    if (z < S - 1) {
      if constexpr (kFft) {
        // a and v in the same passes, v through may; the step's db planes
        // arrive in the meantime.
        stage_async(stage, d, P);
        stage_async(stage + P, b, P);
        fft_propagate<kStepPT, true, kStepPInv>(a, scr, plan, v, may);
        stage_wait();
      } else {
        propagate(a, scr, my, mx, ny, nx);
        propagate<true>(v, scr, my, mx, ny, nx);
      }
    }
    if constexpr (kFft) {
      d = stage;
      b = stage + P;
    }
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      float2 t, t_inv;
      modulator_and_inverse(to_float(d[p]), to_float(b[p]), neg_k1, neg_sk1,
                            &t, &t_inv);
      const float2 wv = cmul(v[p], t_inv);
      const float2 av = a[p];
      const float2 aw = cmul(av, wv);
      if (M == 1) {
        store_slice_grad(gd, gb, p, aw, t, neg_k1, sk1);
      } else {
        scr[p] = aw;
      }
      a[p] = cmul(av, t);
      v[p] = wv;
    }
    if (M == 1) {
      __syncthreads();
    } else {
      cross_mode_sum<T, kGlobal>(scr, d, b, gd, gb, P, M, m, neg_k1, neg_sk1,
                                 sk1, (size_t)kBwdPlanes * P);
    }
  }

  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    const float2 ae = a[e];
    gw[wave_off + e] = make_float2(ae.x, -ae.y);
  }
}

// The forward block holds the wave and a scratch plane, the backward block
// the cotangent, the rebuilt wave and a scratch plane; both one pair of
// mat slots (and on the FFT route the table).
template <typename T>
int launch_fwd(int route, const void* db, const void* w0, const void* ay,
               const void* bx, const void* fay, const void* fbx, void* out,
               int S, int M, int N, int ny, int nx, float neg_k1,
               float neg_sk1, void* ws, cudaStream_t stream) {
  decltype(&fwd_kernel<T, false>) kernel;
  size_t smem;
  if (!pick_route(route, kFwdPlanes, ny, nx, &fwd_kernel<T, false>,
                  &fwd_kernel<T, false, true>,
                  &fwd_kernel<T, false, false, true>, &kernel, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(kernel, N, M, smem, false, stream, static_cast<const T*>(db),
                static_cast<const float2*>(w0),
                static_cast<const float2*>(ay), static_cast<const float2*>(bx),
                static_cast<const float2*>(fay),
                static_cast<const float2*>(fbx), static_cast<float2*>(out),
                static_cast<T*>(nullptr), S, M, N, ny, nx, neg_k1, neg_sk1,
                static_cast<float2*>(ws));
}

template <typename T>
int launch_bwd(int route, const void* db, const void* out, const void* g,
               const void* ay, const void* bx, const void* fay,
               const void* fbx, const void* iay, const void* ibx, void* gdb,
               void* gw, int S, int M, int N, int ny, int nx, float neg_k1,
               float neg_sk1, float sk1, void* ws, cudaStream_t stream) {
  if (M > kMaxModes) return (int)cudaErrorInvalidValue;
  decltype(&bwd_kernel<T, false>) kernel;
  size_t smem;
  if (!pick_route(route, kBwdPlanes, ny, nx, &bwd_kernel<T, false>,
                  &bwd_kernel<T, true>, &bwd_kernel<T, false, true>, &kernel,
                  &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(kernel, N, M, smem, true, stream, static_cast<const T*>(db),
                static_cast<const float2*>(out), static_cast<const float2*>(g),
                static_cast<const float2*>(ay), static_cast<const float2*>(bx),
                static_cast<const float2*>(fay),
                static_cast<const float2*>(fbx),
                static_cast<const float2*>(iay),
                static_cast<const float2*>(ibx), static_cast<T*>(gdb),
                static_cast<float2*>(gw), S, M, N, ny, nx, neg_k1, neg_sk1,
                sk1, static_cast<float2*>(ws));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (db and gdb).  route: 0 dense (ay, bx
// the folded step mats), 1 FFT (ay, bx the step's vectors hy/ny, hx/nx;
// refused for a shape without its radix split), 2 global (as dense; ws a
// workspace of N M ny nx complex planes, two a block forward and three
// backward, else unused).  The far-field pointers may be null (no far field
// folded into the last step).  Returns the CUDA error code of the launch (0
// on success).
extern "C" int k4_fwd(int dtype, int route, const void* db, const void* w0,
                      const void* ay, const void* bx, const void* fay,
                      const void* fbx, void* out, int S, int M, int N, int ny,
                      int nx, float neg_k1, float neg_sk1, void* ws,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(route, db, w0, ay, bx, fay, fbx, out, S, M, N,
                             ny, nx, neg_k1, neg_sk1, ws, st);
  return launch_fwd<__nv_bfloat16>(route, db, w0, ay, bx, fay, fbx, out, S,
                                   M, N, ny, nx, neg_k1, neg_sk1, ws, st);
}

extern "C" int k4_bwd(int dtype, int route, const void* db, const void* out,
                      const void* g, const void* ay, const void* bx,
                      const void* fay, const void* fbx, const void* iay,
                      const void* ibx, void* gdb, void* gw, int S, int M,
                      int N, int ny, int nx, float neg_k1, float neg_sk1,
                      float sk1, void* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(route, db, out, g, ay, bx, fay, fbx, iay, ibx,
                             gdb, gw, S, M, N, ny, nx, neg_k1, neg_sk1, sk1,
                             ws, st);
  return launch_bwd<__nv_bfloat16>(route, db, out, g, ay, bx, fay, fbx, iay,
                                   ibx, gdb, gw, S, M, N, ny, nx, neg_k1,
                                   neg_sk1, sk1, ws, st);
}
