// Complete-grid overlap-add of patch cotangents into the object-gradient
// accumulator, in place.
//
// Replaces the Pallas kernel of adorym_tpu/ops/pallas_scatter_grid.py:
//   _band_kernel (:44, launched by grid2d_tile :68 through
//   scatter_grid2d_add_pallas :182),
// together with the caller's accumulator update that follows it there
// (dynamic_slice + add + dynamic_update_slice).
//
// Math: patch (r, j) of a rows x cols grid, cotangent element (n, iy, ix, c)
// with n = r*cols + j, lands at (y0 + r*stride + iy, x0 + j*stride + ix, c)
// of acc[Ya, Xa, C]; every tile element sums, in f32, the patches that cover
// it (r ascending, then j ascending), then adds that sum to the accumulator.
// The cotangents come in one of two memory layouts:
//   patch-major:   cot[N, py, px, C]  (c innermost);
//   channel-major: cot[C, N, py, px]  (ix innermost), the z-major layout the
//     multislice kernels' gradient has, read in place so that the caller
//     needs no transposing copy (0.7 GB per delta_beta flagship angle).
//
// What bounds it on the H100: bytes.  The cotangents are read once (529 x
// 72 x 72 x C values: 0.70 GB f32 at C = 64, 5.6 GB at C = 512, half that in
// bf16) and the tile of the accumulator is read and written once (16 MB /
// 126 MB each way): 0.22 ms and 1.75 ms f32 at 3.35 TB/s.  There is no
// arithmetic to speak of.
//
// Design: a thread owns V elements that are contiguous along the
// cotangent's innermost axis (V = 4 f32 or 8 bf16: one 16-byte load; V = 1,
// the scalar instantiation, where the shape or the pointers do not allow
// it) and sums the patches that cover them, one patch row r at a time.
// Every cotangent byte is read exactly once, there are no atomics, and the
// summation order is fixed: the result does not depend on V, on the layout
// or on scheduling (the vector and scalar instantiations agree bit for bit).
//   patch-major: the V elements run along c, a warp's load is 512
//     contiguous bytes of one site, and a thread loads its row's covering
//     patches into registers (streaming, evict-first: each byte is read
//     once and the stack is far larger than L2) before it adds them.  Its
//     sums go straight to the accumulator, whose innermost axis is c, in
//     16-byte words.
//   channel-major, V > 1 (bulk copies, TMA): the V elements run along X
//     (stride % V == 0, so a vector lies inside patch j or outside it).  A
//     patch row is only 288 (bf16 144) bytes, stored 20 KB from the next
//     patch's and 11 MB from the next channel's, so what sets the speed is
//     how long the runs are that are read together.  A block owns 8 (bf16
//     16) tile rows x up to 256 X x 8 channels and takes its channels in
//     turn; for each patch row r covering its rows, one warp copies the
//     block's rows of every patch (r, j) into shared memory with
//     cp.async.bulk, one copy of whole contiguous rows a patch (up to 2304
//     bytes), completing on an mbarrier, two such steps in flight while
//     the threads add the one before, each its own covering patches in
//     order.  A thread adds its 8 channels' sums to the accumulator
//     itself, 32 bytes along c a vector element.  (Measured on the H100
//     against loads into registers, which the compiler issues one or two
//     at a time, and against cp.async into each thread's own slots: PERF.md
//     section 6.)
//   channel-major, V = 1: a block owns 128 X x 2 channels of one tile row,
//     a thread one element, and the sums turn round through shared memory
//     so that the accumulator is read and written along c.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads of a patch-major or scalar block
constexpr int kTileX = 128;    // X values of a scalar channel-major block
constexpr int kBandC = 8;      // channels of a bulk-copy block

// The patch columns covering any of a scalar channel-major block's X values
// at the flagship (px / stride + kTileX / stride - 1 at stride 8): the lanes
// of a channel walk them kCols at a time.
constexpr int kCols = kTileX / 8 + 8;

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

// The grid's geometry.
struct Grid {
  int rows, cols, py, px, C, stride, Tx, Ty, Xa, y0, x0;
};

// The first and last patch index (row or column) covering tile coordinate
// x: patch q covers it when q*stride <= x < q*stride + p.
__device__ __forceinline__ int cover_lo(int x, int p, int stride) {
  return x - p + 1 > 0 ? (x - p + stride) / stride : 0;
}
__device__ __forceinline__ int cover_hi(int x, int count, int stride) {
  return min(count - 1, x / stride);
}

// Adds to s[0..V) the cotangents covering tile elements (Y, X + v) (layout
// channel-major, one channel) or (Y, X, c + v) (patch-major), r ascending
// and then j ascending.  The walk over j runs from jw_lo to jw_hi, kB at a
// time, and a lane loads patch j where it covers X (and so the whole
// vector); the caller makes the walk the same for all lanes of a warp
// where they span several patch columns.  at(r, j, iy) is the offset of the
// thread's first element in patch (r, j) at patch row iy; consecutive j lie
// dj elements apart.  A thread that is not `live` loads nothing.  The
// batch is loaded into registers, zeros where a load is off (a sum starts
// at +0 and never becomes -0, so adding them leaves it unchanged bit for
// bit).
template <typename T, int V, int kB, typename At>
__device__ __forceinline__ void cover_sum(const T* __restrict__ cot,
                                          const Grid& g, int Y, int X,
                                          bool live, int jw_lo, int jw_hi,
                                          int64_t dj, At at, float* s) {
  using L = Vec<T, V>;
  const int r_lo = cover_lo(Y, g.py, g.stride);
  const int r_hi = cover_hi(Y, g.rows, g.stride);
  const int j_lo = cover_lo(X, g.px, g.stride);
  const int j_hi = live ? cover_hi(X, g.cols, g.stride) : -1;
  for (int r = r_lo; r <= r_hi; ++r) {
    const T* p = cot + at(r, jw_lo, Y - r * g.stride);
    for (int j0 = jw_lo; j0 <= jw_hi; j0 += kB) {
      typename L::Raw raw[kB];
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        const int j = j0 + k;
        raw[k] = L::load(p + (j - jw_lo) * dj, j >= j_lo && j <= j_hi);
      }
#pragma unroll
      for (int k = 0; k < kB; ++k) L::add(s, raw[k]);
    }
  }
}

// Patch-major: one thread per (X, V channels) of tile row Y = blockIdx.y,
// channels fastest; C % V == 0.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    scatter_patch_major(const T* __restrict__ cot, float* __restrict__ acc,
                        Grid g) {
  const int cv = g.C / V;
  const int64_t item = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (item >= (int64_t)g.Tx * cv) return;
  const int X = (int)(item / cv);
  const int c = (int)(item - (int64_t)X * cv) * V;
  const int Y = blockIdx.y;
  const int64_t C = g.C;
  const int64_t row = (int64_t)g.px * C;  // one patch row
  // Element (n, iy, ix, c) with n = r*cols + j and ix = X - j*stride.
  auto at = [&](int r, int j, int iy) {
    return ((int64_t)(r * g.cols + j) * g.py + iy) * row +
           (int64_t)(X - j * g.stride) * C + c;
  };
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = 0.f;
  // The lanes of a warp share X (or two neighbours, at narrow C): each
  // walks its own columns, 9 at a time (px / stride at the flagship).
  cover_sum<T, V, 9>(cot, g, Y, X, true, cover_lo(X, g.px, g.stride),
                     cover_hi(X, g.cols, g.stride), g.py * row - g.stride * C,
                     at, s);
  float* a = acc + ((int64_t)(g.y0 + Y) * g.Xa + (g.x0 + X)) * C + c;
  if constexpr (V == 1) {
    a[0] += s[0];
  } else {
#pragma unroll
    for (int v = 0; v < V; v += 4) {
      float4 o = *reinterpret_cast<float4*>(a + v);
      o.x += s[v];
      o.y += s[v + 1];
      o.z += s[v + 2];
      o.w += s[v + 3];
      *reinterpret_cast<float4*>(a + v) = o;
    }
  }
}

// Channel-major, V > 1, by bulk copies (TMA): a block owns kRows tile rows
// from blockIdx.z * kRows, the kTmaX X values from blockIdx.x * kTmaX (the
// whole tile at the flagship) and the kBandC channels from blockIdx.y *
// kBandC; a thread V consecutive X of one row.  For each channel and each
// patch row r covering the block's rows (a step), warp 0 copies those rows
// of every patch (r, j) of the window into shared memory
// with cp.async.bulk, one copy of whole contiguous rows a patch (a row at
// a time where the patch leaves the window), completing on an mbarrier;
// two steps are in flight, in two buffers, while the threads add the step
// before from shared memory, each its own covering patches in order.
constexpr int kTmaThreads = 512;
constexpr int kTmaX = 256;

template <int V>
struct TmaBlock {
  static constexpr int kLanes = kTmaX / V;             // threads a row
  static constexpr int kRows = kTmaThreads / kLanes;   // 8 f32, 16 bf16
};

// Patch columns a bulk-copy block's buffer holds; the elements of one
// column's rows in a buffer, padded by 8 so that the lanes reading the
// same row of neighbouring patches fall on different banks; and the
// dynamic shared memory of the two buffers (host and device).
__host__ __device__ inline int tma_cols(int cols, int px, int stride) {
  return min(cols, (kTmaX + px) / stride + 1);
}
template <int V>
__host__ __device__ inline int tma_col_elems(int px) {
  return TmaBlock<V>::kRows * px + 8;
}
template <typename T, int V>
__host__ __device__ inline size_t tma_stage_bytes(const Grid& g) {
  return 2 * sizeof(T) * (size_t)tma_cols(g.cols, g.px, g.stride) *
         tma_col_elems<V>(g.px);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <typename T, int V>
__global__ void __launch_bounds__(kTmaThreads)
    scatter_channel_major_tma(const T* __restrict__ cot,
                              float* __restrict__ acc, Grid g) {
  using L = Vec<T, V>;
  using Raw = typename L::Raw;
  constexpr int kLanes = TmaBlock<V>::kLanes;
  constexpr int kRows = TmaBlock<V>::kRows;
  extern __shared__ uint4 smem[];
  __shared__ uint64_t full[2];
  T* buf0 = reinterpret_cast<T*>(smem);
  const int ncap = tma_cols(g.cols, g.px, g.stride);
  const int col_elems = tma_col_elems<V>(g.px);
  const int64_t buf_elems = (int64_t)ncap * col_elems;
  const int X0 = blockIdx.x * kTmaX, c0 = blockIdx.y * kBandC;
  const int Y0 = blockIdx.z * kRows;
  const int y = threadIdx.x / kLanes;
  const int X = X0 + (threadIdx.x - y * kLanes) * V;
  const int Y = Y0 + y;
  const bool live = X < g.Tx && Y < g.Ty;
  const int64_t plane = (int64_t)g.py * g.px;
  const int64_t N = (int64_t)g.rows * g.cols;
  const int x_end = min(X0 + kTmaX, g.Tx);
  const int jw_lo = cover_lo(X0, g.px, g.stride);
  const int n_cols = cover_hi(x_end - 1, g.cols, g.stride) - jw_lo + 1;
  const int y_end = min(Y0 + kRows, g.Ty);
  const int r_lo = cover_lo(Y0, g.py, g.stride);
  const int n_r = cover_hi(y_end - 1, g.rows, g.stride) - r_lo + 1;
  const int steps = kBandC * n_r;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(&full[b])),
                   "r"(1)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The block's rows that patch row r covers: tile rows [lo, hi), patch
  // rows from lo - r*stride.
  auto rows_of = [&](int r, int* lo, int* hi) {
    *lo = max(Y0, r * g.stride);
    *hi = min(y_end, r * g.stride + g.py);
  };
  // Warp 0 issues step k into buffer k % 2.
  auto issue = [&](int k) {
    const int ch = k / n_r, r = r_lo + k % n_r;
    const int b = k & 1;
    T* dst0 = buf0 + b * buf_elems;
    const unsigned bar = smem_u32(&full[b]);
    int lo, hi;
    rows_of(r, &lo, &hi);
    const int nrows = hi - lo;
    const bool on = c0 + ch < g.C && nrows > 0;
    const T* src0 = cot + ((int64_t)(c0 + ch) * N + (int64_t)r * g.cols +
                           jw_lo) * plane +
                    (int64_t)(lo - r * g.stride) * g.px;
    // The threads' reads of this buffer (ordered by the barrier before)
    // come before the copies' writes.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    unsigned bytes = 0;
    for (int jj = threadIdx.x; jj < n_cols; jj += 32) {
      const int x = (jw_lo + jj) * g.stride;
      const int a = max(X0, x) - x, e = min(x_end, x + g.px) - x;
      bytes += on ? (unsigned)(nrows * (e - a) * sizeof(T)) : 0u;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) bytes += __shfl_xor_sync(~0u, bytes, o);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(bar), "r"(bytes)
                   : "memory");
    }
    __syncwarp();
    if (!on) return;
    for (int jj = threadIdx.x; jj < n_cols; jj += 32) {
      const int x = (jw_lo + jj) * g.stride;
      const int a = max(X0, x) - x, e = min(x_end, x + g.px) - x;
      const T* src = src0 + jj * plane;
      T* dst = dst0 + (int64_t)jj * col_elems;
      if (a == 0 && e == g.px) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
            "l"(src), "r"((unsigned)(nrows * g.px * sizeof(T))), "r"(bar)
            : "memory");
      } else {
        for (int q = 0; q < nrows; ++q) {
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
              "bytes [%0], [%1], %2, [%3];\n" ::"r"(
                  smem_u32(dst + q * g.px + a)),
              "l"(src + q * g.px + a), "r"((unsigned)((e - a) * sizeof(T))),
              "r"(bar)
              : "memory");
        }
      }
    }
  };
  if (threadIdx.x < 32) {
    issue(0);
    if (steps > 1) issue(1);
  }
  const int j_lo = cover_lo(X, g.px, g.stride);
  const int j_hi = live ? cover_hi(X, g.cols, g.stride) : -1;
  float s[kBandC][V];
  int k = 0;
#pragma unroll
  for (int ch = 0; ch < kBandC; ++ch) {
#pragma unroll
    for (int v = 0; v < V; ++v) s[ch][v] = 0.f;
    for (int r = r_lo; r < r_lo + n_r; ++r, ++k) {
      const int b = k & 1;
      const unsigned bar = smem_u32(&full[b]);
      const unsigned parity = (k >> 1) & 1;
      unsigned done = 0;
      while (!done) {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.b32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
      }
      const int iy = Y - r * g.stride;
      if (c0 + ch < g.C && iy >= 0 && iy < g.py) {
        int lo, hi;
        rows_of(r, &lo, &hi);
        const T* row = buf0 + b * buf_elems + (int64_t)(Y - lo) * g.px;
        for (int j = j_lo; j <= j_hi; ++j) {
          L::add(s[ch], *reinterpret_cast<const Raw*>(
                            row + (int64_t)(j - jw_lo) * col_elems + X -
                            j * g.stride));
        }
      }
      __syncthreads();
      if (threadIdx.x < 32 && k + 2 < steps) issue(k + 2);
    }
  }
  if (!live) return;
  float* a = acc + ((int64_t)(g.y0 + Y) * g.Xa + (g.x0 + X)) * g.C + c0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int ch = 0; ch < kBandC; ch += 4) {
      if (c0 + ch < g.C) {
        float4* p = reinterpret_cast<float4*>(a + (int64_t)v * g.C + ch);
        float4 o = *p;
        o.x += s[ch][v];
        o.y += s[ch + 1][v];
        o.z += s[ch + 2][v];
        o.w += s[ch + 3][v];
        *p = o;
      }
    }
  }
}

// Channel-major, V = 1: a block owns kTileX X values from blockIdx.x *
// kTileX x the 2 channels from 2 blockIdx.y of tile row Y = blockIdx.z; a
// thread one element (X fastest).  The lanes of a channel walk the block's
// columns in step (cover_sum), and the sums turn round through shared
// memory so that the accumulator is read and written along c.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scatter_channel_major_scalar(const T* __restrict__ cot,
                                 float* __restrict__ acc, Grid g) {
  constexpr int kTC = kThreads / kTileX;  // channels a block
  __shared__ float sums[kTC][kTileX + 1];
  const int X0 = blockIdx.x * kTileX, c0 = blockIdx.y * kTC;
  const int Y = blockIdx.z;
  const int ci = threadIdx.x / kTileX;
  const int xi = threadIdx.x - ci * kTileX;
  const int X = X0 + xi, c = c0 + ci;
  const int64_t plane = (int64_t)g.py * g.px;  // one patch
  const int64_t N = (int64_t)g.rows * g.cols;
  // Element (c, n, iy, ix) with n = r*cols + j and ix = X - j*stride.
  auto at = [&](int r, int j, int iy) {
    return ((int64_t)c * N + (int64_t)r * g.cols + j) * plane +
           (int64_t)iy * g.px + X - j * g.stride;
  };
  float s = 0.f;
  cover_sum<T, 1, kCols>(
      cot, g, Y, X, X < g.Tx && c < g.C, cover_lo(X0, g.px, g.stride),
      cover_hi(min(X0 + kTileX, g.Tx) - 1, g.cols, g.stride),
      plane - g.stride, at, &s);
  sums[ci][xi] = s;
  __syncthreads();
  // Back along c, the accumulator's innermost axis.
  const int cl = threadIdx.x % kTC, xl = threadIdx.x / kTC;
  if (X0 + xl < g.Tx && c0 + cl < g.C) {
    acc[((int64_t)(g.y0 + Y) * g.Xa + (g.x0 + X0 + xl)) * g.C + c0 + cl] +=
        sums[cl][xl];
  }
}

template <typename T, int V>
cudaError_t launch(int channel_major, const void* cot, void* acc,
                   const Grid& g, cudaStream_t st) {
  const T* c = static_cast<const T*>(cot);
  float* a = static_cast<float*>(acc);
  const int x_blocks = (g.Tx + kTileX - 1) / kTileX;
  if (!channel_major) {
    const int64_t items = (int64_t)g.Tx * (g.C / V);
    const dim3 grid((unsigned)((items + kThreads - 1) / kThreads), g.Ty);
    scatter_patch_major<T, V><<<grid, kThreads, 0, st>>>(c, a, g);
  } else if constexpr (V == 1) {
    constexpr int kTC = kThreads / kTileX;
    const dim3 grid(x_blocks, (g.C + kTC - 1) / kTC, g.Ty);
    scatter_channel_major_scalar<T><<<grid, kThreads, 0, st>>>(c, a, g);
  } else {
    constexpr int kRows = TmaBlock<V>::kRows;
    const size_t smem = tma_stage_bytes<T, V>(g);
    const cudaError_t set = cudaFuncSetAttribute(
        scatter_channel_major_tma<T, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (set != cudaSuccess) return set;
    const dim3 grid((g.Tx + kTmaX - 1) / kTmaX, (g.C + kBandC - 1) / kBandC,
                    (g.Ty + kRows - 1) / kRows);
    scatter_channel_major_tma<T, V><<<grid, kTmaThreads, smem, st>>>(c, a,
                                                                     g);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 cotangents; channel_major: 0 for
// cot[N, py, px, C], 1 for cot[C, N, py, px]; vec: the elements a thread
// owns, 1 or 16 bytes' worth (4 f32, 8 bf16); the accumulator is f32
// [Ya, Xa, C] contiguous.  The caller guarantees py % stride == 0,
// px % stride == 0, that the tile lies inside the accumulator and, for
// vec > 1, 16-byte aligned pointers, C % 4 == 0 and stride % vec == 0
// (channel-major) or C % vec == 0 (patch-major).  Returns the CUDA error
// code of the launch (0 on success; cudaErrorInvalidValue for a vec the
// dtype does not take).
extern "C" int k2_grid_scatter_add(int dtype, int channel_major, int vec,
                                   const void* cot, void* acc, int rows,
                                   int cols, int py, int px, int C,
                                   int stride, int Xa, int y0, int x0,
                                   void* stream) {
  const Grid g{rows, cols, py, px, C, stride,
               cols * stride + px - stride, rows * stride + py - stride,
               Xa, y0, x0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1) {
    return (int)launch<float, 1>(channel_major, cot, acc, g, st);
  }
  if (dtype == 0 && vec == 4) {
    return (int)launch<float, 4>(channel_major, cot, acc, g, st);
  }
  if (dtype == 1 && vec == 1) {
    return (int)launch<__nv_bfloat16, 1>(channel_major, cot, acc, g, st);
  }
  if (dtype == 1 && vec == 8) {
    return (int)launch<__nv_bfloat16, 8>(channel_major, cot, acc, g, st);
  }
  return (int)cudaErrorInvalidValue;
}
