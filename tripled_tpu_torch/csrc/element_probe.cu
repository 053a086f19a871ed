// Overlapping row-window sum for Hopper (sm_90a):
//   out[b, t*th + r, c] = x[b, t*th + r, c] + x[b, t*th + r + 1, c]
//                         + x[b, t*th + r + 2, c]     for r < th, t < n_tiles
// read through (win, W) row windows that start every th rows and overlap by
// win - th rows: the SSIM row halo that the photometric kernels need.
//
// Replaces the Pallas kernel of dev/element_probe.py:40 (`main`'s `kernel`,
// its pl.Element row windows of (WIN=24, W) at row stride TH=16).
//
// Design: one block per (column strip, tile, batch) stages its window, halo
// rows included, in shared memory with coalesced loads (thread i loads
// column i of every row), then each thread sums three rows of its column
// out of shared memory and writes th rows. The sum is taken in the order
// x0 + x1 + x2, as the plain version takes it, so the two agree bit for bit.
//
// What bounds it on the H100: bytes. Each input element is needed once and
// each output element written once: B*R*W*4 + B*n_tiles*th*W*4 bytes and
// two adds per output element. At the flagship's photometric candidate slab
// (B*K*C = 144 planes, R = 328, W = 1024, 20 tiles) that is 193.5 MB read
// and 188.7 MB written, 0.114 ms at 3.35 TB/s. The kernel reads the
// win - th overlap rows twice (1.5x the input for win=24, th=16), mostly
// from L2.
//
// Why CUDA C++ and not Triton: the port's kernels are nvcc-built and bound
// with ctypes, so the CPU tests need no Triton and one build step serves
// every kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStrip = 128;  // columns per block, one thread each

__global__ void row_window_sum_kernel(const float* __restrict__ x, float* __restrict__ out,
                                      int R, int W, int th, int win, int n_tiles) {
  extern __shared__ float window[];  // (win, kStrip)
  const int col0 = blockIdx.x * kStrip;
  const int tile = blockIdx.y;
  const int b = blockIdx.z;
  const int c = col0 + threadIdx.x;
  const float* src = x + ((int64_t)b * R + (int64_t)tile * th) * W;
  float* dst = out + ((int64_t)b * n_tiles * th + (int64_t)tile * th) * W;

  // stage the window: rows [tile*th, tile*th + win) of this strip
  for (int r = 0; r < win; ++r) {
    window[r * kStrip + threadIdx.x] = c < W ? src[(int64_t)r * W + c] : 0.0f;
  }
  __syncthreads();

  if (c >= W) return;
  for (int r = 0; r < th; ++r) {
    float acc = window[r * kStrip + threadIdx.x];
    acc += window[(r + 1) * kStrip + threadIdx.x];
    acc += window[(r + 2) * kStrip + threadIdx.x];
    dst[(int64_t)r * W + c] = acc;
  }
}

}  // namespace

extern "C" int element_probe_row_window_sum(const float* x, float* out, int B, int R, int W,
                                            int th, int win, int n_tiles,
                                            cudaStream_t stream) {
  dim3 grid((W + kStrip - 1) / kStrip, n_tiles, B);
  size_t smem = (size_t)win * kStrip * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        row_window_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  row_window_sum_kernel<<<grid, kStrip, smem, stream>>>(x, out, R, W, th, win, n_tiles);
  return (int)cudaGetLastError();
}
