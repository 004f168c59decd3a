// Complete-grid patch gather from the padded object: the forward
// counterpart of grid_scatter.cu, and its exact transpose.
//
// Replaces the Pallas kernel of adorym_tpu/ops/pallas_scatter_grid.py:
//   _extract_kernel (:110, launched by grid2d_extract :118 through
//   extract_grid2d_pallas :156),
// together with the dynamic_slice of the grid's footprint that precedes it
// there (:168): this kernel reads the object in place from the grid origin.
//
// Math: patch (r, j) of a rows x cols grid, n = r*cols + j, is
//   out[n, iy, ix, c] = obj[y0 + r*stride + iy, x0 + j*stride + ix, c]
// for obj[Y, X, C] with C the flattened trailing axes ((z, 2) of the
// object).  A pure copy: the bytes come out as they went in, so the kernel
// moves words and is the same for f32 and bf16 objects.
//
// What bounds it on the H100: bytes.  At the real_imag flagship the 529
// patches of 72 x 72 x 256 x 2 f32 are 5.62 GB written, against 0.13 GB of
// the grid's footprint read once: about 1.7 ms at 3.35 TB/s (bf16 half).
//
// Design: for fixed (n, iy) the output row out[n, iy, :, :] is one
// contiguous run of px*C values, and so is its source, obj[y, x .. x+px, :]
// with y = y0 + r*stride + iy, x = x0 + j*stride.  One block per (iy, n)
// copies that run in words of 16 bytes (8 or 4 when the run or the
// pointers are not 16-byte aligned), neighbouring threads on neighbouring
// words, so every load and every store is coalesced.  Each source byte is
// read by up to ky*kx overlapping patches; blocks of neighbouring patches
// run together, so the re-reads come from L2, and device memory sees about
// one read of the footprint and one write of the patches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// A 4-, 8- or 16-byte word.
template <int B> struct Word;
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

// obj [Y, Xo, site] and out [N, py, px, site] in words; site = C values.
template <typename W>
__global__ void __launch_bounds__(kThreads)
    extract_kernel(const W* __restrict__ obj, W* __restrict__ out,
                   int64_t site, int Xo, int cols, int py, int px,
                   int stride, int y0, int x0) {
  const int iy = blockIdx.x;
  const int n = blockIdx.y;
  const int r = n / cols;
  const int j = n - r * cols;
  const int64_t run = (int64_t)px * site;
  const W* src =
      obj + ((int64_t)(y0 + r * stride + iy) * Xo + (x0 + j * stride)) * site;
  W* dst = out + ((int64_t)n * py + iy) * run;
  for (int64_t e = threadIdx.x; e < run; e += kThreads) dst[e] = src[e];
}

template <int B>
int launch(const void* obj, void* out, int64_t site_bytes, int Xo, int rows,
           int cols, int py, int px, int stride, int y0, int x0,
           cudaStream_t stream) {
  using W = typename Word<B>::T;
  const dim3 grid(py, rows * cols);
  extract_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(obj), static_cast<W*>(out), site_bytes / B, Xo,
      cols, py, px, stride, y0, x0);
  return (int)cudaGetLastError();
}

}  // namespace

// obj: contiguous [Y, Xo, C] of any element type, site_bytes = C times the
// element size; out: contiguous [rows*cols, py, px, C].  word: 16, 8 or 4,
// dividing site_bytes and both pointers.  The caller guarantees the
// grid's footprint lies inside obj and rows*cols <= 65535.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int k3_grid_extract(const void* obj, void* out, int word,
                               long long site_bytes, int Xo, int rows,
                               int cols, int py, int px, int stride, int y0,
                               int x0, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (word) {
    case 16:
      return launch<16>(obj, out, site_bytes, Xo, rows, cols, py, px, stride,
                        y0, x0, st);
    case 8:
      return launch<8>(obj, out, site_bytes, Xo, rows, cols, py, px, stride,
                       y0, x0, st);
    case 4:
      return launch<4>(obj, out, site_bytes, Xo, rows, cols, py, px, stride,
                       y0, x0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
