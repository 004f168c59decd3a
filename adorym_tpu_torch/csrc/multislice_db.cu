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
//   a   <- a t_z,  v <- w
//   cu   = sum_m a_m v_m;  gb = -k1 Re(cu), gd = s k1 Im(cu).
// cu is the slice's cotangent (sum_m a_m w_m) t, formed from the pair after
// the modulation ((a t) w), so the sum needs no t.
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
// Design: one block per (batch item, probe mode), as K1's
// (multislice_common.cuh).  The backward block keeps its mode's cotangent
// a, its rebuilt wave v and their scratch planes.  At M > 1 the M blocks of
// a patch form a thread-block cluster and sum cu through distributed shared
// memory in mode order (k4_mode_sum on the FFT route, msdb::cross_mode_sum
// on the others).
//
// Two routes for the steps, chosen by the wrapper from the shape alone:
//   FFT   (route 1; ny and nx each n1 n2 with 2 <= n1 <= n2 <= 9, so 72 =
//         8 x 9): each step is six passes of two-stage transforms in shared
//         memory with msdb::fft_propagate's passes and arithmetic, which do
//         the FFT count of work the bound uses.  A pass at 72x72 has 648 or
//         576 items of 8 or 9 points; what holds it back on the H100 is the
//         latency of its shared-memory loads and barriers with 16 warps an
//         SM, so K4 keeps more warps resident than fft_propagate's blocks:
//         K4f two blocks of 512 threads an SM: its block is the plane, a
//         scratch plane and the table (86 KB at 72x72): it reads the step's
//         db planes through L2, asked for a step ahead (prefetch.global.L2),
//         instead of staging them in shared memory (which took one block an
//         SM), and folds the modulation into the first pass's loads
//         (k4_step_fwd).  The far field, once a launch, reads its mats from
//         device memory.
//         K4b one block of 768 threads an SM, 24 warps (212 KB: a, v, two
//         scratch planes, the next step's db planes copied in with cp.async
//         while the step before propagates, the table), with
//         fft_propagate's passes a and v in the same walk; cu needs no t,
//         so the mode sum computes no transmission.
//         Timed by tools/ab_k4_routes.py on an H100 (700 W) at the 5-mode
//         cell's launch (S=256, M=5, N=460): K4f 37.47 -> 31.86 ms, K4b
//         93.95 -> 89.03 ms (in one A/B of thread counts, 89.2 at 768
//         threads against 93.1 at 512, 94.4 at 672, 92.0 at 1024).  Tried
//         and slower: forms that held a pass's items across a barrier (in
//         place, two blocks an SM, K4b too: two items of 9 points and their
//         table loads spill past the 64 registers a thread of two 512-thread
//         blocks has), K4b taking a's and v's item i in one iteration, the
//         modulation in K4b's last pass, K4f staging its db planes at 1024
//         threads, and this route's cu and mode sum on the dense route
//         (K4b 6-7% slower there), whose backward keeps (sum a w) t.
//   dense (route 0; any other shape): the folded step mats in the mat
//         slots, two 72-deep complex matmuls per propagation, about 6.4
//         times the FFT count; the backward serves a with the transposed
//         mats (Py^T, Px) and v with the same conjugated on load, since
//         P^-1 = conj(P^T) (207 KB at 72x72).  The far field enters once,
//         as dense products in the two mat slots: at the last forward
//         step, and at the backward's start (F^T for a, then the exact
//         inverse for v).
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
// The threads of K4b's FFT-route block (one an SM): 24 warps.
constexpr int kBwdThreads = 768;

// -- K4's FFT step ------------------------------------------------------------
//
// K4f's step: the passes and the arithmetic of msdb::fft_propagate<kStepP>
// (its comment has the stages, orders and strides), one item an iteration,
// with the step's modulation on the first pass's loads (`pro(x, p)` takes
// element x as loaded from offset p and returns it), so no loop over the
// plane runs between steps.  K4b takes msdb::fft_propagate itself.

// The work of one item between its loads and its stores (msdb::fft_item's).
template <int R, int kPass, bool kInv, int kH>
__device__ __forceinline__ void k4_item_math(float2 (&x)[R], int g, int n1,
                                             int n,
                                             const float2* __restrict__ tw,
                                             const float2* __restrict__ he) {
  Dft<R, kInv>::run(x, tw, n / R);
  if constexpr (kPass == kPassA) {
#pragma unroll
    for (int k = 1; k < R; ++k) x[k] = cmul(x[k], root<kInv>(tw, g * k));
  } else if constexpr (kPass == kPassB) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float2 hc = he[g + n1 * k];
      if (kH == 2) hc.y = -hc.y;
      x[k] = cmul(x[k], hc);
    }
    Dft<R, !kInv>::run(x, tw, n / R);
#pragma unroll
    for (int j = 1; j < R; ++j) x[j] = cmul(x[j], root<!kInv>(tw, g * j));
  }
}

// A pass's lines and strides (msdb::fft_item's), its radix split and its
// table rows.
struct PassGeo {
  int lines, s_ls, s_es, d_ls, d_es, n1, n;
  const float2* tw;
  const float2* he;
};

struct AsLoaded {
  __device__ __forceinline__ float2 operator()(float2 x, int) const {
    return x;
  }
};

// Item `it` of a pass (R points) of the plane src: loaded, hooked, worked
// and stored into dst.
template <int R, int kPass, bool kInv, int kH, typename Pro>
__device__ __forceinline__ void k4_item(const float2* __restrict__ src,
                                        float2* __restrict__ dst, int it,
                                        const PassGeo& g, const Pro& pro) {
  const int n2 = g.n / g.n1;
  const int grp = it / g.lines;
  const int l = it - grp * g.lines;
  const int pos0 = pass_b(kPass) ? n2 * grp : grp;
  const int step = pass_b(kPass) ? 1 : n2;
  const int s0 = l * g.s_ls + pos0 * g.s_es, ss = step * g.s_es;
  const int d0 = l * g.d_ls + pos0 * g.d_es, ds = step * g.d_es;
  float2 x[R];
#pragma unroll
  for (int j = 0; j < R; ++j) x[j] = pro(src[s0 + j * ss], s0 + j * ss);
  k4_item_math<R, kPass, kInv, kH>(x, grp, g.n1, g.n, g.tw, g.he);
#pragma unroll
  for (int k = 0; k < R; ++k) dst[d0 + k * ds] = x[k];
}

// One pass at the radix given at run time (n2 for pass B, else n1), one
// item an iteration; ends with a barrier.
template <int kPass, bool kInv, int kH, typename Pro = AsLoaded>
__device__ __forceinline__ void k4_pass(const float2* src, float2* dst,
                                        const PassGeo& g,
                                        const Pro& pro = {}) {
  const int items = g.lines * (pass_b(kPass) ? g.n1 : g.n / g.n1);
#define MSDB_K4_PASS(R)                                                  \
  case R:                                                                \
    for (int it = threadIdx.x; it < items; it += blockDim.x) {           \
      k4_item<R, kPass, kInv, kH>(src, dst, it, g, pro);                 \
    }                                                                    \
    break;
  switch (pass_b(kPass) ? g.n / g.n1 : g.n1) {
    MSDB_K4_PASS(2)
    MSDB_K4_PASS(3)
    MSDB_K4_PASS(4)
    MSDB_K4_PASS(5)
    MSDB_K4_PASS(6)
    MSDB_K4_PASS(7)
    MSDB_K4_PASS(8)
    MSDB_K4_PASS(9)
  }
#undef MSDB_K4_PASS
  __syncthreads();
}

// w <- P w through the scratch plane scr (fft_propagate<kStepP>'s passes:
// the y passes first and last on the plane's own layout, the x passes
// between on the odd stride), `pro` on the first pass's loads.
template <typename Pro>
__device__ __forceinline__ void k4_step_fwd(float2* w, float2* scr,
                                            const FftPlan& f,
                                            const Pro& pro) {
  const int ny = f.ny, nx = f.nx, sp = f.sp;
  k4_pass<kPassA, false, 0>(w, scr, {nx, 1, nx, 1, sp, f.y1, ny, f.twy,
                                     nullptr}, pro);
  k4_pass<kPassB, false, 1>(scr, w, {nx, 1, sp, 1, sp, f.y1, ny, f.twy,
                                     f.hy});
  k4_pass<kPassA, false, 0>(w, scr, {ny, sp, 1, sp, 1, f.x1, nx, f.twx,
                                     nullptr});
  k4_pass<kPassB, false, 1>(scr, w, {ny, sp, 1, sp, 1, f.x1, nx, f.twx,
                                     f.hx});
  k4_pass<kPassC, true, 0>(w, scr, {ny, sp, 1, sp, 1, f.x1, nx, f.twx,
                                    nullptr});
  k4_pass<kPassC, true, 0>(scr, w, {nx, 1, sp, 1, nx, f.y1, ny, f.twy,
                                    nullptr});
}

// The slice gradient of one FFT-route backward step at M > 1: every block
// of the patch's cluster has put its mode's a_m v_m into `part`; block m
// sums all M planes for its share of the pixels, in mode order and in f32,
// reading the other blocks' shared memory in place, and stores gdb; the
// second barrier keeps every plane alive until all blocks have read it.
// No atomics: the result does not depend on timing.  msdb::cross_mode_sum
// without the transmission: cu needs none.
template <typename T>
__device__ void k4_mode_sum(const float2* part, T* gd, T* gb, int P, int M,
                            int m, float neg_k1, float sk1) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = (P + M - 1) / M;
  const int p0 = m * share;
  const int p1 = min(P, p0 + share);
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    float2 cu = make_float2(0.f, 0.f);
    for (int r = 0; r < M; ++r) {
      const float2 x = cluster.map_shared_rank(part, r)[p];
      cu.x += x.x;
      cu.y += x.y;
    }
    gb[p] = from_float<T>(neg_k1 * cu.x);
    gd[p] = from_float<T>(sk1 * cu.y);
  }
  cluster.sync();
}

// K4f's hook: the step's modulation on the first pass's loads, the db
// planes read where they lie (L2, asked for a step ahead by prefetch_l2).
template <typename T>
struct Modulate {
  const T* __restrict__ d;
  const T* __restrict__ b;
  float neg_k1, neg_sk1;
  __device__ __forceinline__ float2 operator()(float2 x, int p) const {
    return cmul(x, modulator(to_float(d[p]), to_float(b[p]), neg_k1,
                             neg_sk1));
  }
};

// Asks L2 for the n elements of T at src, a 128-byte line a thread.
template <typename T>
__device__ __forceinline__ void prefetch_l2(const T* src, int n) {
  const char* c = reinterpret_cast<const char*>(src);
  const size_t bytes = sizeof(T) * (size_t)n;
  for (size_t o = (size_t)threadIdx.x * 128; o < bytes;
       o += (size_t)blockDim.x * 128) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + o));
  }
}

// One pixel of a backward step's modulation: from a and v (the wave after
// the step's modulation), t and 1/t of the slice: cu = a v (into part, or
// at M = 1 the slice's gradient itself), a <- a t, v <- v / t.
template <typename T>
__device__ __forceinline__ void k4_unmodulate(float2 av, float2 vv, float d,
                                              float b, int p, float2* a,
                                              float2* v, float2* part, T* gd,
                                              T* gb, int M, float neg_k1,
                                              float neg_sk1, float sk1) {
  float2 t, t_inv;
  modulator_and_inverse(d, b, neg_k1, neg_sk1, &t, &t_inv);
  const float2 cu = cmul(av, vv);
  if (M == 1) {
    gb[p] = from_float<T>(neg_k1 * cu.x);
    gd[p] = from_float<T>(sk1 * cu.y);
  } else {
    part[p] = cu;
  }
  a[p] = cmul(av, t);
  v[p] = cmul(vv, t_inv);
}

// db [S, 2, N, P]; out, g, gw [M, N, P] complex (g and gw in PyTorch's
// convention); gdb [S, 2, N, P] in T.  ay/bx: the TRANSPOSED step mats
// (Py^T, Px), or with kFft the step's vectors hy/ny and hx/nx.  fay/fbx:
// the transposed far-field mats (Fy^T, Fx); iay/ibx: the far field's exact
// inverse in the orientation of the forward (Fy^-1, (Fx^-1)^T).  The
// far-field pointers are all null or all set.
template <typename T, bool kFft, bool kGlobal = false>
__global__ void __launch_bounds__(kFft ? kBwdThreads : kThreads)
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
      for (int p = threadIdx.x; p < P; p += blockDim.x) {
        k4_unmodulate(a[p], v[p], to_float(stage[p]), to_float(stage[P + p]),
                      p, a, v, scr, gd, gb, M, neg_k1, neg_sk1, sk1);
      }
    } else {
      for (int p = threadIdx.x; p < P; p += blockDim.x) {
        float2 t, t_inv;
        modulator_and_inverse(to_float(d[p]), to_float(b[p]), neg_k1,
                              neg_sk1, &t, &t_inv);
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
    }
    if (M == 1) {
      __syncthreads();
    } else if constexpr (kFft) {
      k4_mode_sum<T>(scr, gd, gb, P, M, m, neg_k1, sk1);
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

// Dynamic shared memory of K4f's FFT-route block: the plane and the scratch
// plane at the odd row stride, and the table.
inline size_t fwd_fft_smem_bytes(int ny, int nx) {
  return sizeof(float2) * (2 * (size_t)ny * fft_row_stride(nx) +
                           2 * ((size_t)ny + nx));
}

}  // namespace

namespace msdb {

// K4f on the FFT route: one (patch, mode) block, two an SM (see the file's
// comment).  hy/hx: the step's vectors hy/ny and hx/nx; fay/fbx: the far
// field's mats (Fy, Fx^T) or null.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    fwd_kernel(const T* __restrict__ db, const float2* __restrict__ w0,
               const float2* __restrict__ hy, const float2* __restrict__ hx,
               const float2* __restrict__ fay, const float2* __restrict__ fbx,
               float2* __restrict__ out, int S, int M, int N, int ny, int nx,
               float neg_k1, float neg_sk1) {
  extern __shared__ float2 smem[];
  const int P = ny * nx;
  const int Q = ny * fft_row_stride(nx);
  float2* w = smem;
  float2* scr = w + Q;
  const int n = blockIdx.x / M;
  const int m = blockIdx.x - n * M;
  const size_t wave_off = ((size_t)m * N + n) * P;
  const size_t plane = (size_t)N * P;
  const FftPlan plan = fft_plan(scr + Q, hy, hx, ny, nx);
  copy_to_smem(w, w0 + wave_off, P);
  __syncthreads();

  const T* d = db + (size_t)n * P;  // step z's delta plane (beta: + plane)
  for (int z = 0; z < S - 1; ++z, d += 2 * plane) {
    prefetch_l2(d + 2 * plane, P);
    prefetch_l2(d + 3 * plane, P);
    k4_step_fwd(w, scr, plan, Modulate<T>{d, d + plane, neg_k1, neg_sk1});
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    w[p] = cmul(w[p], modulator(to_float(d[p]), to_float(d[plane + p]),
                                neg_k1, neg_sk1));
  }
  if (fay != nullptr) {
    __syncthreads();
    propagate<false, true>(w, scr, fay, fbx, ny, nx);
  }
  for (int e = threadIdx.x; e < P; e += blockDim.x) out[wave_off + e] = w[e];
}

}  // namespace msdb

namespace {

// K4f's FFT-route kernel (msdb::fwd_kernel<T>), named by its type among
// the forward kernels of the same name.
template <typename T>
using FftFwd = void (*)(const T*, const float2*, const float2*,
                        const float2*, const float2*, const float2*, float2*,
                        int, int, int, int, int, float, float);

template <typename T>
FftFwd<T> fft_fwd_kernel() {
  return &fwd_kernel<T>;
}

// The kernel and dynamic shared memory of K4f / K4b on `route` (false when
// the shape does not take it).
template <typename T>
bool pick_fwd(int route, int ny, int nx, const void** kernel, size_t* smem) {
  if (route == kRouteFft) {
    if (fft_radix(ny) == 0 || fft_radix(nx) == 0) return false;
    *kernel = reinterpret_cast<const void*>(fft_fwd_kernel<T>());
    *smem = fwd_fft_smem_bytes(ny, nx);
    return true;
  }
  using Dense = decltype(&fwd_kernel<T, false>);
  Dense k;
  if (!pick_route(route, kFwdPlanes, ny, nx, &fwd_kernel<T, false>,
                  static_cast<Dense>(nullptr),
                  &fwd_kernel<T, false, false, true>, &k, smem)) {
    return false;
  }
  *kernel = reinterpret_cast<const void*>(k);
  return true;
}

template <typename T>
bool pick_bwd(int route, int ny, int nx, const void** kernel, size_t* smem) {
  decltype(&bwd_kernel<T, false>) k;
  if (!pick_route(route, kBwdPlanes, ny, nx, &bwd_kernel<T, false>,
                  &bwd_kernel<T, true>, &bwd_kernel<T, false, true>, &k,
                  smem)) {
    return false;
  }
  *kernel = reinterpret_cast<const void*>(k);
  return true;
}

template <typename T>
int launch_fwd(int route, const void* db, const void* w0, const void* ay,
               const void* bx, const void* fay, const void* fbx, void* out,
               int S, int M, int N, int ny, int nx, float neg_k1,
               float neg_sk1, void* ws, cudaStream_t stream) {
  const void* k;
  size_t smem;
  if (!pick_fwd<T>(route, ny, nx, &k, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  if (route == kRouteFft) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    return launch(fft_fwd_kernel<T>(), N, M, smem, false, kThreads, stream,
                  static_cast<const T*>(db), static_cast<const float2*>(w0),
                  static_cast<const float2*>(ay),
                  static_cast<const float2*>(bx),
                  static_cast<const float2*>(fay),
                  static_cast<const float2*>(fbx), static_cast<float2*>(out),
                  S, M, N, ny, nx, neg_k1, neg_sk1);
  }
  return launch(reinterpret_cast<decltype(&fwd_kernel<T, false>)>(k), N, M,
                smem, false, kThreads, stream, static_cast<const T*>(db),
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
  const void* k;
  size_t smem;
  if (!pick_bwd<T>(route, ny, nx, &k, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(
      reinterpret_cast<decltype(&bwd_kernel<T, false>)>(k), N, M, smem, true,
      route == kRouteFft ? kBwdThreads : kThreads, stream,
      static_cast<const T*>(db), static_cast<const float2*>(out),
      static_cast<const float2*>(g), static_cast<const float2*>(ay),
      static_cast<const float2*>(bx), static_cast<const float2*>(fay),
      static_cast<const float2*>(fbx), static_cast<const float2*>(iay),
      static_cast<const float2*>(ibx), static_cast<T*>(gdb),
      static_cast<float2*>(gw), S, M, N, ny, nx, neg_k1, neg_sk1, sk1,
      static_cast<float2*>(ws));
}

// Resident blocks an SM of a kernel with `smem` bytes of dynamic shared
// memory: the occupancy calculator's, or at M > 1 (the backward's clusters
// of M blocks) the clusters the card holds at once, times M, over its SMs.
int blocks_per_sm(const void* kernel, size_t smem, int M, bool cluster,
                  int threads, float* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (!cluster || M == 1) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
    *out = (float)blocks;
    return (int)err;
  }
  int dev = 0, sms = 0, clusters = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(sms, M, threads, smem, true, nullptr, attr);
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  *out = (float)clusters * (float)M / (float)sms;
  return (int)err;
}

template <typename T>
int occupancy(int backward, int route, int M, int ny, int nx, float* out) {
  const void* k;
  size_t smem;
  const bool ok = backward ? pick_bwd<T>(route, ny, nx, &k, &smem)
                           : pick_fwd<T>(route, ny, nx, &k, &smem);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (!backward && route == kRouteFft) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = backward && route == kRouteFft ? kBwdThreads
                                                     : kThreads;
  return blocks_per_sm(k, smem, M, backward != 0, threads, out);
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

// Resident blocks an SM of K4f (backward = 0) or K4b (1) for the launch of
// that dtype, route, modes and plane (see blocks_per_sm) into *out: a host
// query of the occupancy calculator, no launch and no synchronisation.
// Returns the CUDA error code.
extern "C" int k4_blocks_per_sm(int backward, int dtype, int route, int M,
                                int ny, int nx, float* out) {
  if (dtype == 0) return occupancy<float>(backward, route, M, ny, nx, out);
  return occupancy<__nv_bfloat16>(backward, route, M, ny, nx, out);
}
