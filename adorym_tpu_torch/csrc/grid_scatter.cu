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
// it, then adds that sum to the accumulator.  The cotangents come in one of
// two memory layouts:
//   layout 0, patch-major:   cot[N, py, px, C]  (c innermost);
//   layout 1, channel-major: cot[C, N, py, px]  (ix innermost), the z-major
//     layout the multislice kernel's gradient has, read in place so that
//     the caller needs no transposing copy (0.7 GB per flagship angle).
//
// What bounds it on the H100: the cotangents are read once (flagship:
// 529 x 72 x 72 x 64 f32 = 0.70 GB, half that in bf16) and the 248 x 248 x
// 64 tile of the accumulator is read and written once (16 MB each way); no
// arithmetic to speak of, so it is bound by bytes: about 0.22 ms f32.
//
// Design: one block per (Y, 32 X values, 32 channels) of the tile, one
// thread per element.  Phase 1 gathers each element's (at most ky x kx)
// covering patches in a fixed order, with the warp's lanes along the
// cotangent's innermost axis (c for layout 0, X for layout 1) so the loads
// are contiguous, and leaves the sums in shared memory.  Phase 2 reads them
// back with the lanes along c and does one contiguous read-modify-write of
// the accumulator.  Every cotangent byte is read exactly once, there are no
// atomics, and the result does not depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // X values and channels per block; blockDim 32x32

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Sum of the cotangents covering tile element (Y, X, c).
template <typename T>
__device__ __forceinline__ float cover_sum(const T* __restrict__ cot,
                                           int channel_major, int Y, int X,
                                           int c, int rows, int cols, int py,
                                           int px, int C, int stride) {
  // Patch row r covers Y when r*stride <= Y < r*stride + py.
  const int r_lo = Y - py + 1 > 0 ? (Y - py + stride) / stride : 0;
  const int r_hi = min(rows - 1, Y / stride);
  const int j_lo = X - px + 1 > 0 ? (X - px + stride) / stride : 0;
  const int j_hi = min(cols - 1, X / stride);
  const int64_t N = (int64_t)rows * cols;
  float sum = 0.f;
  for (int r = r_lo; r <= r_hi; ++r) {
    const int iy = Y - r * stride;
    for (int j = j_lo; j <= j_hi; ++j) {
      const int64_t n = (int64_t)r * cols + j;
      const int ix = X - j * stride;
      const int64_t off =
          channel_major ? ((c * N + n) * py + iy) * px + ix
                        : ((n * py + iy) * px + ix) * C + c;
      sum += to_float(cot[off]);
    }
  }
  return sum;
}

template <typename T>
__global__ void __launch_bounds__(kTile * kTile)
    grid_scatter_kernel(const T* __restrict__ cot, float* __restrict__ acc,
                        int channel_major, int rows, int cols, int py,
                        int px, int C, int stride, int Tx, int Xa, int y0,
                        int x0) {
  __shared__ float sums[kTile][kTile + 1];  // [channel][X], padded
  const int lane = threadIdx.x, row = threadIdx.y;
  const int X0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int Y = blockIdx.z;
  // Phase 1: lanes along the cotangent's innermost axis.
  const int xi = channel_major ? lane : row;
  const int ci = channel_major ? row : lane;
  if (X0 + xi < Tx && c0 + ci < C) {
    sums[ci][xi] = cover_sum(cot, channel_major, Y, X0 + xi, c0 + ci, rows,
                             cols, py, px, C, stride);
  }
  __syncthreads();
  // Phase 2: lanes along c, the accumulator's innermost axis.
  const int X = X0 + row, c = c0 + lane;
  if (X < Tx && c < C) {
    acc[((int64_t)(y0 + Y) * Xa + (x0 + X)) * C + c] += sums[lane][row];
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 cotangents; channel_major: 0 for
// cot[N, py, px, C], 1 for cot[C, N, py, px]; the accumulator is f32
// [Ya, Xa, C] contiguous.  The caller guarantees py % stride == 0,
// px % stride == 0 and that the tile lies inside the accumulator.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int k2_grid_scatter_add(int dtype, int channel_major,
                                   const void* cot, void* acc, int rows,
                                   int cols, int py, int px, int C,
                                   int stride, int Xa, int y0, int x0,
                                   void* stream) {
  const int Ty = rows * stride + py - stride;
  const int Tx = cols * stride + px - stride;
  const dim3 block(kTile, kTile);
  const dim3 grid((Tx + kTile - 1) / kTile, (C + kTile - 1) / kTile, Ty);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    grid_scatter_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(cot), static_cast<float*>(acc),
        channel_major, rows, cols, py, px, C, stride, Tx, Xa, y0, x0);
  } else {
    grid_scatter_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(cot), static_cast<float*>(acc),
        channel_major, rows, cols, py, px, C, stride, Tx, Xa, y0, x0);
  }
  return (int)cudaGetLastError();
}
