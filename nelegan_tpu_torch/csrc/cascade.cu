// Four cascaded one-pole recurrences y[n] = x[n] + a*y[n-1] along each row,
// the gammatone denominator 1/(1 - a z^-1)^4, with a per-row pole `a`.
//
// Replaces: nelegan_tpu/ops/pallas_scan.py, `gammatone_cascade_pallas` and
// its body `_cascade_kernel` (pallas_scan.py:37-104), vmapped over rows.
// The TPU kernel turns each 128-sample block into a Toeplitz matmul for
// the TPU's matrix unit; this port does not carry that over.
//
// What bounds it on an H100: memory, in principle.  [64, 36000] float32 in
// and out is 18.4 MB, about 5.5 us at 3.35 TB/s, and the 8 flops per
// sample are far below the card's float32 rate.  This kernel is the simple
// correct form instead: one thread per row, the four stage carries in
// float32 registers and a sequential loop over n.  It therefore pays the
// whole dependency chain, n samples times four dependent FMAs, on only
// R threads (two warps at R = 64), and its loads are strided by a row
// across the threads of a warp.  A chunked scan with a carry fix-up, or the
// Toeplitz block on tensor cores, is the way to the memory bound.

#include <cuda_runtime.h>

namespace {

__global__ void gammatone_cascade_kernel(const float* __restrict__ x,
                                         const float* __restrict__ a,
                                         float* __restrict__ y, int rows,
                                         int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float ar = a[r];
  const float* xr = x + (size_t)r * n;
  float* yr = y + (size_t)r * n;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    c0 = xr[i] + ar * c0;
    c1 = c0 + ar * c1;
    c2 = c1 + ar * c2;
    c3 = c2 + ar * c3;
    yr[i] = c3;
  }
}

}  // namespace

// x, y: [rows, n] float32 contiguous; a: [rows] float32.
extern "C" int gammatone_cascade_f32(const float* x, const float* a, float* y,
                                     int rows, int n, void* stream) {
  if (rows <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  const int threads = 64;
  const int blocks = (rows + threads - 1) / threads;
  gammatone_cascade_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x, a, y, rows, n);
  return (int)cudaGetLastError();
}
