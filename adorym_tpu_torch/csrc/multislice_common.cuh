// Shared pieces of the multislice kernels (K1 in multislice_db_stored.cu,
// K4 in multislice_db.cu, K5 in multislice_fused.cu): storage-type helpers,
// the slice transmission, the shared-memory complex matmul and the folded
// propagation, the FFT step propagation of K1 and K4 (fft_propagate) and
// of K5, whose transfer function need not be separable (fft_propagate2d),
// the forward sweep K1 runs (and K4 on its dense and global routes), and
// the deterministic cross-mode sum of their backward sweeps (K4b's FFT
// route has its own, k4_mode_sum in multislice_db.cu).
//
// Layouts (row-major): db [S, 2, N, P] (slot 0 delta, slot 1 beta, P =
// ny*nx); waves [M, N, P] complex; records [S, M, N, P] complex pairs of T;
// mats complex [n, n].  Every kernel runs one block per (patch n, probe
// mode m), blockIdx.x = n*M + m, so a block holds one wave in shared memory
// whatever M is.  The backward sweeps need gt = sum_m a_m w_m across the
// blocks of a patch: they launch as a thread-block cluster of the patch's M
// blocks (see cross_mode_sum).
//
// The global route (route 2) takes a plane whose block fits no shared-memory
// route (K1 from 88x88, K4 from 80x80 without the FFT split): the same
// kernels with kGlobal, the block's planes in a slice of a device-memory
// workspace (ws, `planes` ny*nx planes a block, blockIdx.x-major) and the
// folded mats read where they lie.  Nothing else changes: the matmuls take
// generic pointers, and a block's threads share its SM's L1, which holds
// the planes it works on; __syncthreads orders the block's device-memory
// accesses as it orders shared memory.

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

// -- The FFT step propagation (the FFT route of K1 and K4) -------------------
//
// The paraxial step P = G diag(h) F of each axis, unfolded: per axis a DFT,
// the product with h/n, an unnormalised inverse DFT, with F = dft_matrix(n)
// and G = conj(F)/n.  The backward sweeps need two more variants of the
// same step:
//   kStepP     P                  FFT, x h/n, inverse FFT (the forwards')
//   kStepPT    P^T = F diag(h) G  inverse FFT, x h/n, FFT (the cotangent)
//   kStepPInv  P^-1 = G diag(h*) F  FFT, x conj(h)/n, inverse FFT (K4b's
//                                   rebuilt wave)
// Each axis's transforms have length n = n1 n2, two Cooley-Tukey stages,
// and the transform back runs the transpose of the forward's stages, so an
// axis takes three passes over the plane from shared memory to shared
// memory (fft_pass): the forward's first stage; its second stage, the
// axis's h and the first stage back, all in registers; the last stage back.
// 6 passes a step, ping-ponging between the plane and the scratch plane, at
// the FFT count of work.  K4b runs its two propagations (the cotangent and
// the rebuilt wave) in the same passes.
//
// Inside the step the plane is laid out with an odd row stride (nx | 1):
// the x passes map neighbouring threads to neighbouring rows, and an even
// stride would put a warp's column into 2 of the 16 bank pairs of a float2.
// The first pass reads, and the last writes, the plane's own layout (row
// stride nx), so the rest of the kernel never sees the padding; a plane
// only needs ny (nx | 1) elements of room.
//
// During the steps the mat slots (the far field's, once a launch) hold the
// next step's db planes, copied in with cp.async while the step before
// propagates (stage_async), so the modulation reads shared memory.
//
// What each choice bought on an H100 (700 W), K4 at the multi-mode chunk
// (256 steps, 3 modes, 529 patches of 72x72), by tools/ab_k4_routes.py:
// the odd stride 43.2 against 68.0 ms (K4f); 6 passes instead of 8, 37.3
// -> 31.9 and 92.9 -> 77.7 (K4b); K4b's two planes in the same passes,
// 77.1 -> 68.6; the db planes copied into shared memory during the
// propagation, 31.7 -> 26.6 and 69.0 -> 62.3 (an L2 prefetch in their
// place had given 43.0 -> 37.3 and 99.0 -> 93.3).  The dense route: 107
// and 245 ms.
//
// fft_plan's table holds the step's vectors hy/ny and hx/nx (built by the
// wrapper, fft_step_vectors) and the n-th roots of unity of each axis.
//
// Accuracy against a complex128 sweep of the same steps (chip_smoke's
// check_truth, H100): after 31 binned steps of 8 nm and the far field (K1 on
// the delta_beta chunk) this route is half as far from it as the folded
// mats; after 255 steps of 1 nm (K4 on the multi-mode chunk) the two are
// within 20% of each other, either side by output and norm.  Roots built
// in f64 instead of sincospif came out no nearer, so the remaining error is
// the f32 rounding of the step's factors, which the folded mats share.

constexpr int kMaxRadix = 9;

enum FftStep { kStepP, kStepPT, kStepPInv };

// n1 of the split n = n1 n2 the FFT route takes: the largest n1 with
// 2 <= n1 <= n2 <= kMaxRadix, or 0 when n has none (the dense route).
__host__ __device__ inline int fft_radix(int n) {
  for (int r = kMaxRadix; r >= 2; --r) {
    if (n % r == 0 && r * r <= n && n / r <= kMaxRadix) return r;
  }
  return 0;
}

// The row stride of a plane inside the FFT step: odd.
__host__ __device__ inline int fft_row_stride(int nx) { return nx | 1; }

// Elements of an FFT-route block's region after its planes: the two mat
// slots (the far field, once a launch), which during the steps hold the
// next step's db planes (room for f32: P float2); in K1b also the step's
// record plane (P float2 more in f32, and 2 ny nx <= ny^2 + nx^2 always
// leaves room); in K4b (`planes` = 3) first the rebuilt wave's scratch
// plane.
__host__ __device__ inline int fft_slot_elems(int planes, int ny, int nx) {
  const int mats = ny * ny + nx * nx;
  const int steps = (planes == 3 ? ny * fft_row_stride(nx) : 0) + ny * nx;
  return mats > steps ? mats : steps;
}

// Dynamic shared memory of an FFT-route block: `planes` planes of the padded
// stride, the slot region, and the table: hy, hx and the two axes' roots.
inline size_t fft_smem_bytes(int planes, int ny, int nx) {
  return sizeof(float2) *
         ((size_t)planes * ny * fft_row_stride(nx) +
          fft_slot_elems(planes, ny, nx) + 2 * ((size_t)ny + nx));
}

struct FftPlan {
  const float2* hy;   // [ny] hy/ny
  const float2* hx;   // [nx] hx/nx
  const float2* twy;  // [ny] exp(-2 pi i k/ny)
  const float2* twx;  // [nx] exp(-2 pi i k/nx)
  int ny, nx, y1, x1, sp;
};

// exp(-2 pi i k/n), from sincospif on an argument reduced to [-1, 1].
__device__ __forceinline__ float2 unit_root(int k, int n) {
  const int kk = 2 * k <= n ? k : k - n;
  float sn, cs;
  sincospif(-2.0f * kk / n, &sn, &cs);
  return make_float2(cs, sn);
}

// Fills the table at `tab` (2 (ny + nx) elements) from the step vectors in
// device memory.  The caller's next barrier publishes it.
__device__ __forceinline__ FftPlan fft_plan(float2* tab,
                                            const float2* __restrict__ hy,
                                            const float2* __restrict__ hx,
                                            int ny, int nx) {
  for (int e = threadIdx.x; e < ny + nx; e += blockDim.x) {
    const bool y = e < ny;
    tab[e] = y ? hy[e] : hx[e - ny];
    tab[ny + nx + e] = y ? unit_root(e, ny) : unit_root(e - ny, nx);
  }
  FftPlan f;
  f.hy = tab;
  f.hx = tab + ny;
  f.twy = tab + ny + nx;
  f.twx = f.twy + ny;
  f.ny = ny;
  f.nx = nx;
  f.y1 = fft_radix(ny);
  f.x1 = fft_radix(nx);
  f.sp = fft_row_stride(nx);
  return f;
}

// Starts copying n elements of T from device to shared memory with
// cp.async, 16 bytes a copy, when both sides and the size are 16-byte
// aligned; else copies them at once.  stage_wait() ends the copies.  The
// FFT route copies each step's db planes so while the step before it
// propagates, and its modulation reads shared memory.
template <typename T>
__device__ __forceinline__ void stage_async(T* dst, const T* src, int n) {
  const size_t bytes = sizeof(T) * (size_t)n;
  const char* s = reinterpret_cast<const char*>(src);
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(static_cast<void*>(dst)));
  if ((reinterpret_cast<uintptr_t>(s) | d | bytes) % 16 == 0) {
    for (size_t o = (size_t)threadIdx.x * 16; o < bytes;
         o += (size_t)blockDim.x * 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       d + (unsigned)o),
                   "l"(s + o));
    }
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// The root tw[k] of the table, conjugated for the inverse transform.
template <bool kInv>
__device__ __forceinline__ float2 root(const float2* tw, int k) {
  float2 t = tw[k];
  if (kInv) t.y = -t.y;
  return t;
}

// v times -i (forward) or +i (inverse).
template <bool kInv>
__device__ __forceinline__ float2 rot(float2 v) {
  return kInv ? make_float2(-v.y, v.x) : make_float2(v.y, -v.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

// x <- its R-point DFT, X[k] = sum_j x[j] exp(-+2 pi i jk/R) (+ with kInv),
// in natural order, in registers.  The general radix sums directly with the
// R-th roots tw[m * step] of the table (step = n / R); 2, 3, 4, 8 and 9 are
// butterflies with constant roots.
template <int R, bool kInv>
struct Dft {
  __device__ __forceinline__ static void run(float2 (&x)[R],
                                             const float2* tw, int step) {
    float2 wr[R];
#pragma unroll
    for (int m = 0; m < R; ++m) wr[m] = root<kInv>(tw, m * step);
    float2 y[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float2 acc = x[0];
#pragma unroll
      for (int j = 1; j < R; ++j) acc = cadd(acc, cmul(x[j], wr[(j * k) % R]));
      y[k] = acc;
    }
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = y[k];
  }
};

__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 s = cadd(a, b);
  b = csub(a, b);
  a = s;
}

template <bool kInv>
__device__ __forceinline__ void dft3(float2& a, float2& b, float2& c) {
  const float kS3 = 0.86602540378443865f;  // sqrt(3) / 2
  const float2 s = cadd(b, c);
  const float2 u = cscale(rot<kInv>(csub(b, c)), kS3);
  const float2 t = csub(a, cscale(s, 0.5f));
  a = cadd(a, s);
  b = cadd(t, u);
  c = csub(t, u);
}

template <bool kInv>
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c,
                                     float2& d) {
  const float2 s0 = cadd(a, c), d0 = csub(a, c);
  const float2 s1 = cadd(b, d), d1 = rot<kInv>(csub(b, d));
  a = cadd(s0, s1);
  c = csub(s0, s1);
  b = cadd(d0, d1);
  d = csub(d0, d1);
}

template <bool kInv>
struct Dft<2, kInv> {
  __device__ __forceinline__ static void run(float2 (&x)[2], const float2*,
                                             int) {
    dft2(x[0], x[1]);
  }
};

template <bool kInv>
struct Dft<3, kInv> {
  __device__ __forceinline__ static void run(float2 (&x)[3], const float2*,
                                             int) {
    dft3<kInv>(x[0], x[1], x[2]);
  }
};

template <bool kInv>
struct Dft<4, kInv> {
  __device__ __forceinline__ static void run(float2 (&x)[4], const float2*,
                                             int) {
    dft4<kInv>(x[0], x[1], x[2], x[3]);
  }
};

// 8 = 2 x 4 (and 4 = 2 x 2): the even and odd 4-point DFTs, then the
// radix-2 butterflies with the roots of 8.
template <bool kInv>
struct Dft<8, kInv> {
  __device__ __forceinline__ static void run(float2 (&x)[8], const float2*,
                                             int) {
    const float kC = 0.70710678118654752f;
    const float sg = kInv ? 1.f : -1.f;
    dft4<kInv>(x[0], x[2], x[4], x[6]);
    dft4<kInv>(x[1], x[3], x[5], x[7]);
    const float2 o1 = cmul(x[3], make_float2(kC, sg * kC));
    const float2 o2 = rot<kInv>(x[5]);
    const float2 o3 = cmul(x[7], make_float2(-kC, sg * kC));
    const float2 e0 = x[0], e1 = x[2], e2 = x[4], e3 = x[6], o0 = x[1];
    x[0] = cadd(e0, o0);
    x[4] = csub(e0, o0);
    x[1] = cadd(e1, o1);
    x[5] = csub(e1, o1);
    x[2] = cadd(e2, o2);
    x[6] = csub(e2, o2);
    x[3] = cadd(e3, o3);
    x[7] = csub(e3, o3);
  }
};

// 9 = 3 x 3: j = 3 j1 + j2, k = k1 + 3 k2; 3-point DFTs over j1, the roots
// of 9 w^(j2 k1), 3-point DFTs over j2.
template <bool kInv>
struct Dft<9, kInv> {
  __device__ __forceinline__ static void run(float2 (&x)[9], const float2*,
                                             int) {
    const float sg = kInv ? 1.f : -1.f;
    const float2 w1 = make_float2(0.76604444311897804f, sg * 0.64278760968653933f);
    const float2 w2 = make_float2(0.17364817766693035f, sg * 0.98480775301220806f);
    const float2 w4 = make_float2(-0.93969262078590838f, sg * 0.34202014332566873f);
    dft3<kInv>(x[0], x[3], x[6]);
    dft3<kInv>(x[1], x[4], x[7]);
    dft3<kInv>(x[2], x[5], x[8]);
    // Now x[j2 + 3 k1] holds Y[j2][k1].
    x[4] = cmul(x[4], w1);
    x[7] = cmul(x[7], w2);
    x[5] = cmul(x[5], w2);
    x[8] = cmul(x[8], w4);
    dft3<kInv>(x[0], x[1], x[2]);
    dft3<kInv>(x[3], x[4], x[5]);
    dft3<kInv>(x[6], x[7], x[8]);
    // Now x[3 k1 + k2] holds X[k1 + 3 k2]: transpose to natural order.
    float2 t = x[1];
    x[1] = x[3];
    x[3] = t;
    t = x[2];
    x[2] = x[6];
    x[6] = t;
    t = x[5];
    x[5] = x[7];
    x[7] = t;
  }
};

// One pass of the length-n 1-D transforms (n = n1 n2) of `lines` lines,
// from src to dst.  Element i of line l lies at l*ls + i*es (each side its
// own strides).  With j = n2 j1 + j2 and k = k1 + n1 k2 the forward DFT
// (direction kInv) is two Cooley-Tukey stages, and the DFT back (direction
// !kInv, from natural order to natural order) is their transpose:
//   kPassA (R = n1): for each j2, the DFT over j1 of x[n2 j1 + j2], times
//          the root w^(j2 k1), stored at n2 k1 + j2;
//   kPassB (R = n2): for each k1, the DFT over j2 of those n2 neighbours,
//          which is X[k1 + n1 k2] over k2 in natural order; times he[k1 +
//          n1 k2] (kH = 2: conjugated; kH = 3: he + l n, line l's own row
//          of a 2-D table); the DFT back over k2, times the root of the
//          other direction w^-(j2 k1), stored in place;
//   kPassC (R = n1): for each j2, the DFT back over k1 of the elements at
//          n2 k1 + j2, stored in natural order at n2 j1 + j2 (kH = 4: times
//          1/n, rounded to f32 once, the axis's share of the 2-D step's
//          1/(ny nx)).
// The caller gives pass C the direction back (!kInv of A and B).  Pass B's
// two halves also run alone, for a product that needs the other axis's
// whole spectrum (fft_propagate2d):
//   kPassBF (R = n2): pass B's DFT over j2 only, X[k1 + n1 k2] stored at
//          n2 k1 + k2;
//   kPassBB (R = n2): pass B's second half, in the direction the caller
//          gives (the direction back): the DFT over k2 of the elements at
//          n2 k1 + k2, times the root w^(j2 k1) of that direction, stored
//          in place.
// Items run line-fastest, so a warp's threads take neighbouring lines.
enum FftPass { kPassA, kPassB, kPassC, kPassBF, kPassBB };

// Pass B and its halves take the n2 neighbours of one k1 as an item.
__host__ __device__ constexpr bool pass_b(int pass) {
  return pass == kPassB || pass == kPassBF || pass == kPassBB;
}

// One item of a pass: group g of line l (item it, line-fastest).
template <int R, int kPass, bool kInv, int kH>
__device__ __forceinline__ void fft_item(const float2* __restrict__ src,
                                         float2* __restrict__ dst, int it,
                                         int lines, int s_ls, int s_es,
                                         int d_ls, int d_es, int n1, int n2,
                                         const float2* __restrict__ tw,
                                         const float2* __restrict__ he) {
  const int n = n1 * n2;
  // Element e of a group lies at pos0 + e * pos_step along the line.
  const int pos_step = pass_b(kPass) ? 1 : n2;
  const int g = it / lines;
  const int l = it - g * lines;
  const float2* s = src + l * s_ls;
  float2* d = dst + l * d_ls;
  const int pos0 = pass_b(kPass) ? n2 * g : g;
  float2 x[R];
#pragma unroll
  for (int j = 0; j < R; ++j) x[j] = s[(pos0 + j * pos_step) * s_es];
  Dft<R, kInv>::run(x, tw, n / R);
  if constexpr (kPass == kPassA) {
#pragma unroll
    for (int k = 1; k < R; ++k) x[k] = cmul(x[k], root<kInv>(tw, g * k));
  } else if constexpr (kPass == kPassB) {
    if constexpr (kH == 3) he += l * n;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float2 hc = he[g + n1 * k];
      if (kH == 2) hc.y = -hc.y;
      x[k] = cmul(x[k], hc);
    }
    Dft<R, !kInv>::run(x, tw, n / R);
#pragma unroll
    for (int j = 1; j < R; ++j) x[j] = cmul(x[j], root<!kInv>(tw, g * j));
  } else if constexpr (kPass == kPassBB) {
#pragma unroll
    for (int j = 1; j < R; ++j) x[j] = cmul(x[j], root<kInv>(tw, g * j));
  } else if constexpr (kPass == kPassC && kH == 4) {
    const float inv_n = __frcp_rn((float)n);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      x[k].x *= inv_n;
      x[k].y *= inv_n;
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) d[(pos0 + k * pos_step) * d_es] = x[k];
}

// The pass over one plane (src -> dst) or, with kPair, over two at once
// (src2 -> dst2 in the direction kInv2 with kH2, its items after the
// first plane's), at the radix (n2 for pass B, else n1) given at run time.
// Ends with a barrier.
template <int kPass, bool kInv, int kH, bool kPair, bool kInv2, int kH2>
__device__ __forceinline__ void fft_pass(const float2* src, float2* dst,
                                         const float2* src2, float2* dst2,
                                         int lines, int s_ls, int s_es,
                                         int d_ls, int d_es, int n1, int n,
                                         const float2* tw, const float2* he) {
  const int n2 = n / n1;
  const int items = lines * (pass_b(kPass) ? n1 : n2);
  const int total = kPair ? 2 * items : items;
#define MSDB_FFT_PASS(R)                                                     \
  case R:                                                                    \
    for (int it = threadIdx.x; it < total; it += blockDim.x) {               \
      if (!kPair || it < items) {                                            \
        fft_item<R, kPass, kInv, kH>(src, dst, it, lines, s_ls, s_es, d_ls,  \
                                     d_es, n1, n2, tw, he);                  \
      } else {                                                               \
        fft_item<R, kPass, kInv2, kH2>(src2, dst2, it - items, lines, s_ls,  \
                                       s_es, d_ls, d_es, n1, n2, tw, he);    \
      }                                                                      \
    }                                                                        \
    break;
  switch (pass_b(kPass) ? n2 : n1) {
    MSDB_FFT_PASS(2)
    MSDB_FFT_PASS(3)
    MSDB_FFT_PASS(4)
    MSDB_FFT_PASS(5)
    MSDB_FFT_PASS(6)
    MSDB_FFT_PASS(7)
    MSDB_FFT_PASS(8)
    MSDB_FFT_PASS(9)
  }
#undef MSDB_FFT_PASS
  __syncthreads();
}

// w <- V_y w V_x^T for one ny x nx plane (row stride nx) through the scratch
// plane, V the step variant kStep of each axis: six passes, ping-ponging
// w -> scr -> w.  Per axis, pass A and B take the transform, the axis's h
// and the first stage back; pass C the last stage back.  The y passes come
// first and last: their lines are the columns, so a warp's threads take
// neighbouring columns of the plane's own layout, which the first pass
// reads and the last writes.  The x passes between them work on the odd
// stride.  (The axes' operators commute, so y's pass C may follow x's.)
// With kPair, the same passes also take w2 <- V2_y w2 V2_x^T through scr2,
// V2 the variant kStep2.  Ends with a barrier.
template <int kStep, bool kPair = false, int kStep2 = kStepP>
__device__ __forceinline__ void fft_propagate(float2* w, float2* scr,
                                              const FftPlan& f,
                                              float2* w2 = nullptr,
                                              float2* scr2 = nullptr) {
  constexpr bool kI = kStep == kStepPT;  // the direction of the first half
  constexpr int kH = kStep == kStepPInv ? 2 : 1;
  constexpr bool kI2 = kStep2 == kStepPT;
  constexpr int kH2 = kStep2 == kStepPInv ? 2 : 1;
  const int ny = f.ny, nx = f.nx, sp = f.sp;
  fft_pass<kPassA, kI, 0, kPair, kI2, 0>(w, scr, w2, scr2, nx, 1, nx, 1, sp,
                                         f.y1, ny, f.twy, nullptr);
  fft_pass<kPassB, kI, kH, kPair, kI2, kH2>(scr, w, scr2, w2, nx, 1, sp, 1,
                                            sp, f.y1, ny, f.twy, f.hy);
  fft_pass<kPassA, kI, 0, kPair, kI2, 0>(w, scr, w2, scr2, ny, sp, 1, sp, 1,
                                         f.x1, nx, f.twx, nullptr);
  fft_pass<kPassB, kI, kH, kPair, kI2, kH2>(scr, w, scr2, w2, ny, sp, 1, sp,
                                            1, f.x1, nx, f.twx, f.hx);
  fft_pass<kPassC, !kI, 0, kPair, !kI2, 0>(w, scr, w2, scr2, ny, sp, 1, sp, 1,
                                           f.x1, nx, f.twx, nullptr);
  fft_pass<kPassC, !kI, 0, kPair, !kI2, 0>(scr, w, scr2, w2, nx, 1, sp, 1, nx,
                                           f.y1, ny, f.twy, nullptr);
}

// -- The FFT step with a 2-D transfer function (the FFT route of K5) ---------
//
// K5's step applies any [ny, nx] transfer function H between the forward
// and the inverse 2-D transform; the non-paraxial H is not separable, so
// the product needs the whole 2-D spectrum and cannot sit inside each
// axis's pass B as in fft_propagate.  The step runs pass B of the y axis in
// its two halves around the x axis's three passes, 7 passes a step:
//   y pass A; y pass B, forward half (kPassBF); x pass A; x pass B with
//   the 2-D product (kH = 3); x pass C; y pass B, back half (kPassBB);
//   y pass C.
// Between the y halves, row l of the plane holds the y frequency ky = k1 +
// n1 k2 of l = n2 k1 + k2 (pass B's storage order), so the step table
// holds H with its rows in that order (built by the wrapper,
// cuda_multislice_fused.step_table): x pass B reads its line's row with
// pass B's own indexing.  Each axis's pass C takes its 1/n (kH = 4): so
// taken, rather than rounded into the table as H / (ny nx), the step's
// gain bias, which adds up over the steps, is smaller, and a sweep lands
// nearer a complex128 one (ROADMAP C.2).  Two variants, with G = conj(F)
// / n of each axis:
//   kStepP   w <- G_y G_x (H o (F_y w F_x))   (K5f)
//   kStepPT  F_y F_x (H o (G_y w G_x))        (K5b: JAX's transpose, which
//                                              takes H itself, not conj(H))
// The 7 passes ping-pong from w to scr and back and end in scr: the step's
// result is scr, in the plane's own layout (row stride nx), and w is
// clobbered.  The y passes come first and last, as in fft_propagate, and
// the ones between work on the odd row stride.  Ends with a barrier.

// Fills the table at `tab` (ny + nx elements) with the n-th roots of unity
// of both axes (the plan of fft_propagate2d, which has no step vectors).
// The caller's next barrier publishes it.
__device__ __forceinline__ FftPlan fft_plan2d(float2* tab, int ny, int nx) {
  for (int e = threadIdx.x; e < ny + nx; e += blockDim.x) {
    tab[e] = e < ny ? unit_root(e, ny) : unit_root(e - ny, nx);
  }
  FftPlan f;
  f.hy = nullptr;
  f.hx = nullptr;
  f.twy = tab;
  f.twx = tab + ny;
  f.ny = ny;
  f.nx = nx;
  f.y1 = fft_radix(ny);
  f.x1 = fft_radix(nx);
  f.sp = fft_row_stride(nx);
  return f;
}

template <int kStep>
__device__ __forceinline__ void fft_propagate2d(float2* w, float2* scr,
                                                const FftPlan& f,
                                                const float2* h2) {
  static_assert(kStep == kStepP || kStep == kStepPT,
                "the 2-D step takes P or P^T");
  constexpr bool kI = kStep == kStepPT;  // the direction of the first half
  const int ny = f.ny, nx = f.nx, sp = f.sp;
  fft_pass<kPassA, kI, 0, false, false, 0>(w, scr, nullptr, nullptr, nx, 1,
                                           nx, 1, sp, f.y1, ny, f.twy,
                                           nullptr);
  fft_pass<kPassBF, kI, 0, false, false, 0>(scr, w, nullptr, nullptr, nx, 1,
                                            sp, 1, sp, f.y1, ny, f.twy,
                                            nullptr);
  fft_pass<kPassA, kI, 0, false, false, 0>(w, scr, nullptr, nullptr, ny, sp,
                                           1, sp, 1, f.x1, nx, f.twx,
                                           nullptr);
  fft_pass<kPassB, kI, 3, false, false, 0>(scr, w, nullptr, nullptr, ny, sp,
                                           1, sp, 1, f.x1, nx, f.twx, h2);
  fft_pass<kPassC, !kI, 4, false, false, 0>(w, scr, nullptr, nullptr, ny, sp,
                                            1, sp, 1, f.x1, nx, f.twx,
                                            nullptr);
  fft_pass<kPassBB, !kI, 0, false, false, 0>(scr, w, nullptr, nullptr, nx, 1,
                                             sp, 1, sp, f.y1, ny, f.twy,
                                             nullptr);
  fft_pass<kPassC, !kI, 4, false, false, 0>(w, scr, nullptr, nullptr, nx, 1,
                                            sp, 1, nx, f.y1, ny, f.twy,
                                            nullptr);
}

// The forward sweep of one (patch, mode) block: per step the modulation
// (recording the entering wave in T when kRecords), then the folded step
// propagation, or at the last step the far-field mats when given.  kFft
// (the FFT route of K1f) takes each step through fft_propagate
// instead, with ay and bx the step's vectors hy/ny and hx/nx; the far field
// stays the dense product in the mat slots.  On that route the record
// stores are plain stores issued in the modulation loop, before the step's
// first pass: nothing waits on them, so they drain while the step runs.
// Streaming stores (st.global.cs) in their place measured the same on an
// H100 (K1f 1.498 against 1.497 ms at the delta_beta chunk,
// tools/ab_k4_routes.py).
template <typename T, bool kRecords, bool kFft = false, bool kGlobal = false>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ db, const float2* __restrict__ w0,
               const float2* __restrict__ ay, const float2* __restrict__ bx,
               const float2* __restrict__ fay, const float2* __restrict__ fbx,
               float2* __restrict__ out, T* __restrict__ rec, int S, int M,
               int N, int ny, int nx, float neg_k1, float neg_sk1,
               float2* __restrict__ ws) {
  extern __shared__ float2 smem[];
  const int P = ny * nx;
  const int Q = kFft ? ny * fft_row_stride(nx) : P;
  float2* w = kGlobal ? ws + (size_t)blockIdx.x * 2 * P : smem;
  float2* scr = w + Q;
  float2* may = scr + Q;
  float2* mbx = may + ny * ny;
  // The mats the dense steps read: the slots, or on the global route the
  // step's (then the far field's) mats in device memory.
  const float2* my = kGlobal ? ay : may;
  const float2* mx = kGlobal ? bx : mbx;
  const int n = blockIdx.x / M;
  const int m = blockIdx.x - n * M;
  const size_t wave_off = ((size_t)m * N + n) * P;

  copy_to_smem(w, w0 + wave_off, P);
  FftPlan plan;
  T* stage = reinterpret_cast<T*>(may);  // the FFT route's db planes
  if constexpr (kFft) {
    stage_async(stage, db + (size_t)n * P, P);
    stage_async(stage + P, db + ((size_t)N + n) * P, P);
    plan = fft_plan(mbx + nx * nx, ay, bx, ny, nx);
    stage_wait();
  } else if constexpr (!kGlobal) {
    copy_to_smem(may, ay, ny * ny);
    copy_to_smem(mbx, bx, nx * nx);
  }
  __syncthreads();

  for (int z = 0; z < S; ++z) {
    const T* d = db + ((size_t)(2 * z) * N + n) * P;
    const T* b = db + ((size_t)(2 * z + 1) * N + n) * P;
    T* rz = kRecords ? rec + (((size_t)z * M + m) * N + n) * P * 2 : nullptr;
    if constexpr (kFft) {
      for (int p = threadIdx.x; p < P; p += blockDim.x) {
        if constexpr (kRecords) store_pair(rz + 2 * p, w[p]);
        w[p] = cmul(w[p], modulator(to_float(stage[p]),
                                    to_float(stage[P + p]), neg_k1,
                                    neg_sk1));
      }
    } else {
      for (int p = threadIdx.x; p < P; p += blockDim.x) {
        const float2 t = modulator(to_float(d[p]), to_float(b[p]), neg_k1,
                                   neg_sk1);
        const float2 wv = w[p];
        if (kRecords) store_pair(rz + 2 * p, wv);
        w[p] = cmul(wv, t);
      }
    }
    __syncthreads();
    if constexpr (kFft) {
      if (z < S - 1) {
        stage_async(stage, d + 2 * (size_t)N * P, P);
        stage_async(stage + P, b + 2 * (size_t)N * P, P);
        fft_propagate<kStepP>(w, scr, plan);
        stage_wait();
        continue;
      }
    }
    if (z == S - 1) {
      if (fay == nullptr) break;
      if constexpr (kGlobal) {
        my = fay;
        mx = fbx;
      } else {
        // No thread reads the step mats after the barrier above.
        copy_to_smem(may, fay, ny * ny);
        copy_to_smem(mbx, fbx, nx * nx);
        __syncthreads();
      }
    }
    propagate<false, true>(w, scr, my, mx, ny, nx);
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
// pixels (L2 holds the step's planes).  On the global route (kGlobal) the
// planes lie in the workspace, block r's `peer` elements after block 0's,
// and are read through L2 (__ldcg: the other blocks ran on other SMs, whose
// writes the cluster barrier's release and acquire make visible there).
template <typename T, bool kGlobal = false>
__device__ void cross_mode_sum(float2* part, const T* d, const T* b, T* gd,
                               T* gb, int P, int M, int m, float neg_k1,
                               float neg_sk1, float sk1, size_t peer = 0) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = (P + M - 1) / M;
  const int p0 = m * share;
  const int p1 = min(P, p0 + share);
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    float2 gt = make_float2(0.f, 0.f);
    for (int r = 0; r < M; ++r) {
      float2 v;
      if constexpr (kGlobal) {
        v = __ldcg(part + ((ptrdiff_t)r - m) * (ptrdiff_t)peer + p);
      } else {
        v = cluster.map_shared_rank(part, r)[p];
      }
      gt.x += v.x;
      gt.y += v.y;
    }
    const float2 t = modulator(to_float(d[p]), to_float(b[p]), neg_k1,
                               neg_sk1);
    store_slice_grad(gd, gb, p, gt, t, neg_k1, sk1);
  }
  cluster.sync();
}

// The launch of N*M blocks of `threads` with `smem` bytes of dynamic shared
// memory: plain at M = 1 or without `cluster`, else as clusters of the M
// blocks of one patch, the cluster's attribute held in `attr`.
inline cudaLaunchConfig_t launch_config(int N, int M, int threads,
                                        size_t smem, bool cluster,
                                        cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)N * (unsigned)M);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (cluster && M > 1) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = (unsigned)M;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// Launches `kernel` over N*M blocks of `threads` (launch_config).  Returns
// the CUDA error code.
template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), int N, int M, size_t smem,
           bool cluster, int threads, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(N, M, threads, smem, cluster, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The step routes, as the entry points of K1, K4 and K5 number them.
constexpr int kRouteDense = 0;
constexpr int kRouteFft = 1;
constexpr int kRouteGlobal = 2;

// The kernel of `route`, with its shared memory for a block of `planes`
// planes, or false when the shape does not take the route.  The global
// route takes any shape and no dynamic shared memory.
template <typename K>
bool pick_route(int route, int planes, int ny, int nx, K dense, K fft,
                K global, K* kernel, size_t* smem) {
  if (route == kRouteGlobal) {
    *kernel = global;
    *smem = 0;
    return true;
  }
  if (route == kRouteDense) {
    *kernel = dense;
    *smem = smem_bytes(planes, ny, nx);
    return true;
  }
  if (route != kRouteFft || fft_radix(ny) == 0 || fft_radix(nx) == 0) {
    return false;
  }
  *kernel = fft;
  *smem = fft_smem_bytes(planes, ny, nx);
  return true;
}

}  // namespace msdb
