// One grid row's overlap-add of patch cotangents into the object-gradient
// accumulator, in place: K6.
//
// Replaces the Pallas call of adorym_tpu/ops/pallas_scatter_grid.py:
//   scatter_rowgrid_add_pallas (:193), K2's band kernel (_band_kernel :44,
//   through grid2d_tile :68) at rows = 1 followed by the accumulator update
//   (dynamic_slice + add + dynamic_update_slice).
// The immediate scheme's band step launches it once a minibatch, on the
// minibatch's one grid row; the per-angle path once a grid row of each
// gradient chunk whose rows do not make one complete grid (staggered or
// offset rows, chunks the batch count does not divide).
//
// Math: patch j of the row (j < N), cotangent element (j, iy, ix, c), lands
// at (y0 + iy, x0 + j*stride + ix, c) of acc[Ya, Xa, C]:
//   acc[y0 + iy, x0 + X, c] += sum_j cot[j, iy, X - j*stride, c]
// over the px / stride patches j that cover X (fewer at the row's ends).
// Each sum starts at +0 and takes the patches in ascending j, in f32 (bf16
// cotangents widened exactly), and is then added to the accumulator once:
// the order of K2's kernel at rows = 1, so the two agree bit for bit, and
// so do this kernel's vector and scalar instantiations.  (Where a patch
// does not cover X a zero is added; a sum that starts at +0 is never -0,
// so adding +0 leaves it unchanged.)
// The cotangents come in one of two layouts, both read in place:
//   patch-major:   cot[N, py, px, C]  (c innermost);
//   channel-major: cot[C][N, py, px]  (ix innermost), channel c's patches
//     at c * cs (cs >= N * py * px elements): the z-major gradient of the
//     multislice kernels, a whole row's on the immediate delta_beta band
//     step (cs = N * py * px), or one grid row of a per-angle gradient
//     chunk of g rows (cs = g * N * py * px), read where it lies.
//
// What bounds it on the H100: bytes.  At the immediate flagship's row the
// cotangents are 30.5 MB f32 (15.3 MB bf16), [32, 2, 23, 72, 72], and the
// accumulator's tile [72, 248, 64] f32 is read and written once (4.6 MB
// each way): 0.0118 ms f32, 0.0073 ms bf16 at 3.35 TB/s.  The real_imag
// band row, [23, 72, 72, 256, 2] into [72, 248, 512], moves 317 MB: 0.095
// ms.  Sparse slices' row, [23, 72, 72, 2, 2], moves 2.5 MB: 0.0007 ms,
// so there the launch and the host's call are all of the time.
//
// Design, for one row on 132 SMs:
//   - No loop over patch rows: a thread owns V elements contiguous along
//     the cotangent's innermost axis (V = 4 f32 or 8 bf16, 16 bytes: the
//     vector instantiation; V = 1, the scalar one, for the shapes and
//     pointers the vector one does not take) and issues the loads of all
//     its covering patches (px / stride = 9 at the flagship) before it
//     adds them, so nine 16-byte loads a thread are in flight.  Every
//     cotangent byte is read once, with the streaming policy; no atomics.
//   - channel-major: the V elements run along X (stride % V == 0, so a
//     vector lies inside patch j or outside it).  A warp owns 32 V X of
//     one tile row in two channels (the vector instantiation; one in the
//     scalar one), a block of 8 warps 16 channels of that row and span:
//     the immediate row is 72 rows x 2 spans x 4 channel groups = 576
//     blocks of 256 threads in f32 and 288 in bf16, resident at once in
//     one wave (K2's bulk-copy kernel made 72 and 40 blocks of 512
//     threads, walking 8 channels in turn).  With one channel a warp the
//     f32 row made 1152 blocks, 1.09 waves at full occupancy, and took
//     0.0185-0.0192 ms where two channels take 0.0147; bf16 0.0122-0.0128
//     against 0.0105 (tools/ab_k6.py on the H100, PERF.md section 6).
//     Lanes of neighbouring 8-column groups read neighbouring patches,
//     each group 32 (bf16 16) contiguous bytes an instruction: every
//     sector fetched is used whole.  The sums turn round through shared
//     memory so that the accumulator is read and written along c, in runs
//     of the block's 16 channels (64 bytes; 8 channels, 32 bytes, in the
//     scalar instantiation), 16-byte words in the vector one.
//   - patch-major: the V elements run along c, a thread one (X, V
//     channels) site of one tile row, its sums straight to the
//     accumulator (whose innermost axis is c) in 16-byte words.  The
//     block holds 256 threads, halved (down to 64) until the row makes at
//     least two blocks an SM: sparse slices' row (one vector a site) runs
//     288 blocks of 64 threads where 256-thread blocks would be 72.
//   - A thread loads the accumulator words it will update before its
//     cotangents, so that the latencies of the two reads overlap (a row's
//     blocks are at most a few waves: there is no later work to hide
//     them behind).
//   - No per-launch attribute calls: the blocks' shared memory is static
//     (16.6 KB at most), and the SM count is read once per device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads of a channel-major block
constexpr int kWarps = kThreads / 32;  // warps of a channel-major block
constexpr int kBatch = 9;      // covering patches loaded before they add

// V contiguous cotangent elements, loaded raw with the streaming policy
// (evict-first) or zeros when `on` is false, and unpacked to f32 (bf16
// exactly, as __bfloat162float).
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p, bool on) {
    return on ? __ldcs(p) : 0.f;
  }
  static __device__ __forceinline__ void add(float* s, Raw r) { s[0] += r; }
};

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p, bool on) {
    return on ? __ldcs(reinterpret_cast<const float4*>(p))
              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void add(float* s, Raw r) {
    s[0] += r.x;
    s[1] += r.y;
    s[2] += r.z;
    s[3] += r.w;
  }
};

__device__ __forceinline__ float bf16_lo(unsigned int w) {
  return __bfloat162float(
      __ushort_as_bfloat16((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float bf16_hi(unsigned int w) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w >> 16)));
}

template <>
struct Vec<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p,
                                             bool on) {
    return on ? __ldcs(reinterpret_cast<const unsigned short*>(p))
              : (unsigned short)0;
  }
  static __device__ __forceinline__ void add(float* s, Raw r) {
    s[0] += __bfloat162float(__ushort_as_bfloat16(r));
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p,
                                             bool on) {
    return on ? __ldcs(reinterpret_cast<const uint4*>(p))
              : make_uint4(0u, 0u, 0u, 0u);
  }
  static __device__ __forceinline__ void add(float* s, Raw r) {
    // Element 2k is the low half of word k (little-endian).
    s[0] += bf16_lo(r.x);
    s[1] += bf16_hi(r.x);
    s[2] += bf16_lo(r.y);
    s[3] += bf16_hi(r.y);
    s[4] += bf16_lo(r.z);
    s[5] += bf16_hi(r.z);
    s[6] += bf16_lo(r.w);
    s[7] += bf16_hi(r.w);
  }
};

}  // namespace

// The row's geometry, as the caller's plan holds it (one per operand
// shape): N patches of py x px at `stride`, C channels, the accumulator's
// row length Xa, and (channel-major) the elements between two channels'
// patches, cs.
struct K6Row {
  int N, py, px, C, stride, Xa;
  int64_t cs;
};

namespace {

// Adds to s[0..V) the covering patches of X, j ascending: patch j's
// elements lie at p0 + j * dj (p0: patch 0's offset for X, which may lie
// before the row when patch 0 does not cover X; it is then not read).
// Patches j = X / stride - K + 1 + k, k < K = px / stride, cover X where
// 0 <= j < N; the others add zeros.
template <typename T, int V>
__device__ __forceinline__ void cover_sum(const T* __restrict__ cot,
                                          int64_t p0, int64_t dj, int X,
                                          const K6Row& g, float* s) {
  using L = Vec<T, V>;
  const int K = g.px / g.stride;
  const int j0 = X / g.stride - K + 1;
  for (int k0 = 0; k0 < K; k0 += kBatch) {
    typename L::Raw raw[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int j = j0 + k0 + k;
      const bool on = k0 + k < K && j >= 0 && j < g.N;
      raw[k] = L::load(cot + (on ? p0 + j * dj : 0), on);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) L::add(s, raw[k]);
  }
}

// Channel-major: warp w of block (bx, by, iy) owns the kCPW channels
// by * kWarps * kCPW + w + kWarps * k (k < kCPW) and the 32 V X values from
// bx * 32 V of tile row iy; a lane V consecutive X of each.  kVecOut: the
// accumulator is updated in 16-byte words (C % 4 == 0, 16-byte aligned),
// else one element at a time.  Each thread loads the accumulator words it
// will update before its cotangents, so that the two reads' latencies
// overlap.
template <typename T, int V, bool kVecOut, int kCPW>
__global__ void __launch_bounds__(kThreads)
    rowgrid_channel_major(const T* __restrict__ cot, float* __restrict__ acc,
                          K6Row g, int y0, int x0) {
  constexpr int kSpan = 32 * V;
  constexpr int kBC = kWarps * kCPW;                // channels of the block
  // A row of the turn-round is 4 floats longer than the span (4 mod 32
  // banks), so that the reads along c below fall on distinct banks.
  constexpr int kPitch = kSpan + 4;
  constexpr int kPer = kVecOut ? 4 : 1;         // channels a word
  constexpr int kWords = kBC / kPer;            // words of a site's block
  constexpr int kOut = kSpan * kWords / kThreads;  // words a thread updates
  static_assert(kSpan * kWords % kThreads == 0, "whole words a thread");
  using W = typename std::conditional<kVecOut, float4, float>::type;
  __shared__ __align__(16) float sums[kBC][kPitch];
  const int Tx = (g.N - 1) * g.stride + g.px;
  const int X0 = blockIdx.x * kSpan, c0 = blockIdx.y * kBC;
  const int iy = blockIdx.z;
  // Word o of this thread: site X0 + xo[o], channels c0 + co[o] on.
  float* row = acc + ((int64_t)(y0 + iy) * g.Xa + x0) * g.C;
  int xo[kOut], co[kOut];
  W old[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int i = threadIdx.x + o * kThreads;
    xo[o] = i / kWords;
    co[o] = (i - xo[o] * kWords) * kPer;
    if (X0 + xo[o] < Tx && c0 + co[o] < g.C) {
      old[o] = *reinterpret_cast<const W*>(
          row + (int64_t)(X0 + xo[o]) * g.C + c0 + co[o]);
    }
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int X = X0 + lane * V;
  const int64_t plane = (int64_t)g.py * g.px;
#pragma unroll
  for (int k = 0; k < kCPW; ++k) {
    const int cl = w + kWarps * k, c = c0 + cl;
    float s[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = 0.f;
    if (X < Tx && c < g.C) {
      // Element (c, j, iy, ix) with ix = X - j*stride.
      cover_sum<T, V>(cot, (int64_t)c * g.cs + (int64_t)iy * g.px + X,
                      plane - g.stride, X, g, s);
    }
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int v = 0; v < V; v += 4) {
        *reinterpret_cast<float4*>(&sums[cl][lane * V + v]) =
            make_float4(s[v], s[v + 1], s[v + 2], s[v + 3]);
      }
    } else {
      sums[cl][lane * V] = s[0];
    }
  }
  __syncthreads();
  // Back along c, the accumulator's innermost axis.
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    if (X0 + xo[o] < Tx && c0 + co[o] < g.C) {
      W a = old[o];
      if constexpr (kVecOut) {
        a.x += sums[co[o]][xo[o]];
        a.y += sums[co[o] + 1][xo[o]];
        a.z += sums[co[o] + 2][xo[o]];
        a.w += sums[co[o] + 3][xo[o]];
      } else {
        a += sums[co[o]][xo[o]];
      }
      *reinterpret_cast<W*>(row + (int64_t)(X0 + xo[o]) * g.C + c0 + co[o]) =
          a;
    }
  }
}

// Patch-major: one thread per (X, V channels) of tile row iy = blockIdx.y,
// channels fastest; C % V == 0.  The accumulator's words are loaded before
// the cotangents, as above.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rowgrid_patch_major(const T* __restrict__ cot, float* __restrict__ acc,
                        K6Row g, int y0, int x0) {
  constexpr int kW = V < 4 ? V : 4;  // floats a word of the accumulator
  using W = typename std::conditional<(V < 4), float, float4>::type;
  const int Tx = (g.N - 1) * g.stride + g.px;
  const int cv = g.C / V;
  const int64_t item = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (int64_t)Tx * cv) return;
  const int X = (int)(item / cv);
  const int c = (int)(item - (int64_t)X * cv) * V;
  const int iy = blockIdx.y;
  const int64_t C = g.C;
  W* a = reinterpret_cast<W*>(acc + ((int64_t)(y0 + iy) * g.Xa + (x0 + X)) *
                                        C + c);
  W old[V / kW];
#pragma unroll
  for (int k = 0; k < V / kW; ++k) old[k] = a[k];
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = 0.f;
  // Element (j, iy, ix, c) with ix = X - j*stride.
  cover_sum<T, V>(cot, ((int64_t)iy * g.px + X) * C + c,
                  ((int64_t)g.py * g.px - g.stride) * C, X, g, s);
#pragma unroll
  for (int k = 0; k < V / kW; ++k) {
    W o = old[k];
    if constexpr (V < 4) {
      o += s[k];
    } else {
      o.x += s[4 * k];
      o.y += s[4 * k + 1];
      o.z += s[4 * k + 2];
      o.w += s[4 * k + 3];
    }
    a[k] = o;
  }
}

// The device's SM count, read once per device.
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

template <typename T, int V>
cudaError_t launch(int channel_major, const void* cot, void* acc,
                   const K6Row& g, int y0, int x0, cudaStream_t st) {
  const T* c = static_cast<const T*>(cot);
  float* a = static_cast<float*>(acc);
  const int Tx = (g.N - 1) * g.stride + g.px;
  if (channel_major) {
    constexpr int kSpan = 32 * V;
    constexpr int kCPW = V == 1 ? 1 : 2;
    constexpr int kBC = kWarps * kCPW;
    const dim3 grid((Tx + kSpan - 1) / kSpan, (g.C + kBC - 1) / kBC, g.py);
    rowgrid_channel_major<T, V, (V > 1), kCPW>
        <<<grid, kThreads, 0, st>>>(c, a, g, y0, x0);
  } else {
    const int64_t items = (int64_t)Tx * (g.C / V);
    const int64_t want = 2 * (int64_t)sm_count();
    int threads = kThreads;
    while (threads > 64 &&
           (items + threads - 1) / threads * g.py < want) {
      threads /= 2;
    }
    const dim3 grid((unsigned)((items + threads - 1) / threads), g.py);
    rowgrid_patch_major<T, V><<<grid, threads, 0, st>>>(c, a, g, y0, x0);
  }
  return cudaGetLastError();
}

}  // namespace

// kind: bit 0 the dtype (0 float32, 1 bfloat16 cotangents), bit 1 the
// layout (0 cot[N, py, px, C], 1 cot[C][N, py, px] at channel stride
// row->cs), bit 2 the vector
// instantiation (16 bytes a thread: 4 f32, 8 bf16) instead of the scalar
// one.  The accumulator is f32 [Ya, Xa, C] contiguous.  The caller
// guarantees px % stride == 0, that the row's tile [py, (N-1)*stride + px]
// at (y0, x0) lies inside the accumulator, py <= 65535 and, for the vector
// instantiation, 16-byte aligned pointers, C % 4 == 0 and stride % V == 0
// and cs % V == 0 (channel-major) or C % V == 0 (patch-major).  Returns the
// CUDA error code of the launch (0 on success; cudaErrorInvalidValue for an
// unknown kind).
extern "C" int k6_rowgrid_scatter_add(int kind, const void* cot, void* acc,
                                      const K6Row* row, int y0, int x0,
                                      void* stream) {
  if (kind < 0 || kind > 7) return (int)cudaErrorInvalidValue;
  const K6Row g = *row;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cm = (kind >> 1) & 1;
  switch (kind & 5) {
    case 0:
      return (int)launch<float, 1>(cm, cot, acc, g, y0, x0, st);
    case 4:
      return (int)launch<float, 4>(cm, cot, acc, g, y0, x0, st);
    case 1:
      return (int)launch<__nv_bfloat16, 1>(cm, cot, acc, g, y0, x0, st);
    case 5:
      return (int)launch<__nv_bfloat16, 8>(cm, cot, acc, g, y0, x0, st);
  }
  return (int)cudaErrorInvalidValue;
}
