// Fused photometric min-reprojection for Hopper (sm_90a): forward and
// backward of min_k [0.85 * SSIM_3x3(pred_k, target) + 0.15 * robust_L1],
// averaged over channels, with its argmin (strict <, first candidate wins).
//
// Replaces the Pallas kernels of tripled_tpu/ops/pallas/photometric.py:
//   photometric_fwd  <- _forward_tiled (:200, body _kernel :130)
//   photometric_bwd  <- _backward_tiled (:263), reflect-pad fold included
//
// Layout: target (B, H, W, C) and candidates (B, K, H, W, C), contiguous,
// float32 or bfloat16; all arithmetic is float32. The 3x3 windows read the
// reflect-padded image through index reflection (-1 -> 1, H -> H-2), so no
// padded copy is made.
//
// What bounds it on the H100: at the training shape (B=12, K=4, 192x640,
// C=3, f32) the forward moves ~100 MB (30 us at 3.35 TB/s) and does ~1.9
// GFLOP of f32 arithmetic (~29 us at 67 TFLOP/s), so memory and f32 issue
// are about even. The simple design reads each input texel from L1/L2 nine
// times per candidate (one thread per output pixel, no shared-memory tile)
// and keeps nothing between neighbouring threads; a later version would
// stage a halo tile in shared memory with the backward's load_tile, compute
// the box sums separably, and vectorise the channel loads.
//
// Backward, one launch, deterministic gather form (no atomics, so two runs
// give the same bits). A block owns a kTH x kTW tile of input pixels u (one
// thread each; a warp is a tile row) and stages in shared memory, with
// coalesced NHWC row copies (load_tile, asynchronous for float), the target
// and the visited candidates with a halo of 2, and the forward's idx and
// the incoming gradient g with a halo of 1. The visited candidates are
// those of grad_mask, or all K when the target gradient is asked for (it
// sums over the candidate each output selected), all staged at once. Each
// output o of the halo-1 tile computes the SSIM coefficient maps A, B, G
// (and A2 for the target) of _backward_tiled's docstring once, for the
// candidate it selected, or zeros when that one is not visited or the
// clip is off; then each thread gathers, candidate by candidate, its
// transpose window over the outputs that selected k. Every output whose
// window reads a real pixel r lies in [r-1, r+1], so the halo-1 tile holds
// all of them; the reflect-pad fold is a tap weight of 2 on output 0 for
// r = 1 and on output n-1 for r = n-2. The robust-L1 term is added where
// idx[u] == k, the target's gradient is summed over k in shared memory,
// each warp writes its row of dp_k with coalesced stores from a row
// buffer, and candidates outside grad_mask get zeros in the same launch.
// No coefficient map goes through device memory.
//
// What bounds the backward: at the flagship shape (B=12, K=4, 320x1024,
// C=3, f32, grad_ks = (2, 3), no target gradient) it must move 363 MB
// (0.108 ms at 3.35 TB/s). The tiles re-read their halos (1.4x the image),
// mostly from L2, and instruction throughput and shared-memory reads
// weigh as much as memory: the 3x3 statistics are summed per output, not
// separably, and the gather reads 27 map values per channel and candidate.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kC1 = 0.01f * 0.01f;
constexpr float kC2 = 0.03f * 0.03f;
constexpr int kThreads = 256;

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// SSIM statistics of one channel's 3x3 window centred on (oy, ox).
struct Stats {
  float mu_x, mu_y, sxx, syy, sxy;
};

template <typename T>
__device__ __forceinline__ Stats window_stats(const T* x, const T* y, int H,
                                              int W, int C, int oy, int ox,
                                              int c) {
  float sx = 0.f, sy = 0.f, sxx = 0.f, syy = 0.f, sxy = 0.f;
#pragma unroll
  for (int di = -1; di <= 1; ++di) {
    const int64_t row = (int64_t)reflect(oy + di, H) * W;
#pragma unroll
    for (int dj = -1; dj <= 1; ++dj) {
      const int64_t off = (row + reflect(ox + dj, W)) * C + c;
      const float a = ld(x, off);
      const float b = ld(y, off);
      sx += a;
      sy += b;
      sxx += a * a;
      syy += b * b;
      sxy += a * b;
    }
  }
  return {sx / 9.f, sy / 9.f, sxx / 9.f, syy / 9.f, sxy / 9.f};
}

template <typename T>
__global__ void fwd_kernel(const T* __restrict__ tgt, const T* __restrict__ preds,
                           float* __restrict__ out, int* __restrict__ idx,
                           int B, int K, int H, int W, int C) {
  const int64_t HW = (int64_t)H * W;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B * HW) return;
  const int b = (int)(p / HW);
  const int rem = (int)(p - b * HW);
  const int oy = rem / W;
  const int ox = rem - oy * W;
  const T* y = tgt + b * HW * C;
  const int64_t centre = (int64_t)rem * C;

  float best = INFINITY;
  int best_k = 0;
  for (int k = 0; k < K; ++k) {
    const T* x = preds + ((int64_t)b * K + k) * HW * C;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) {
      const Stats s = window_stats(x, y, H, W, C, oy, ox, c);
      const float sigma_x = s.sxx - s.mu_x * s.mu_x;
      const float sigma_y = s.syy - s.mu_y * s.mu_y;
      const float sigma_xy = s.sxy - s.mu_x * s.mu_y;
      const float n = (2.f * s.mu_x * s.mu_y + kC1) * (2.f * sigma_xy + kC2);
      const float d = (s.mu_x * s.mu_x + s.mu_y * s.mu_y + kC1) *
                      (sigma_x + sigma_y + kC2);
      const float ssim = fminf(fmaxf((1.f - n / d) * 0.5f, 0.f), 1.f);
      const float diff = ld(y, centre + c) - ld(x, centre + c);
      acc += 0.85f * ssim + 0.15f * sqrtf(diff * diff + 1e-6f);
    }
    const float loss = acc / C;
    if (loss < best) {
      best = loss;
      best_k = k;
    }
  }
  out[p] = best;
  idx[p] = best_k;
}

// Stages rows [y0 - halo, y0 + th + halo) and columns [x0 - halo,
// x0 + tw + halo) of one (H, W, C) image, clipped to the image, into a
// shared-memory tile of row pitch (tw + 2 * halo) * C whose first element
// is pixel (y0 - halo, x0 - halo); positions outside the image are left
// unwritten. Each warp copies 32-element pieces of rows, lane i element i.
// A copy between types of one size (float, int) is asynchronous: the
// caller ends its loads with __pipeline_commit() and
// __pipeline_wait_prior(0) before __syncthreads(), so every load of every
// tile is in flight at once. bf16 is widened to float through registers,
// kLoadBatch loads in flight per thread. blockDim.x is a multiple of 32.
constexpr int kLoadBatch = 8;

template <typename S, typename D>
__device__ __forceinline__ void load_tile(const S* __restrict__ img, D* __restrict__ tile,
                                          int H, int W, int C, int y0, int x0, int th,
                                          int tw, int halo) {
  const int r0 = max(y0 - halo, 0), r1 = min(y0 + th + halo, H);
  const int c0 = max(x0 - halo, 0), c1 = min(x0 + tw + halo, W);
  const int row_len = (c1 - c0) * C;
  const int pieces = (row_len + 31) / 32;  // per row
  const float inv_pieces = 1.f / pieces;   // q / pieces below, exact for q < 2^20
  const int pitch = (tw + 2 * halo) * C;
  D* dst = tile + (r0 - y0 + halo) * pitch + (c0 - x0 + halo) * C;
  const S* src = img + ((int64_t)r0 * W + c0) * C;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int n = (r1 - r0) * pieces;
  if constexpr (sizeof(S) == sizeof(D)) {
    for (int q = threadIdx.x >> 5; q < n; q += warps) {
      const int r = __float2int_rz((q + 0.5f) * inv_pieces);
      const int e = (q - r * pieces) * 32 + lane;
      if (e < row_len) {
        __pipeline_memcpy_async(dst + r * pitch + e, src + (int64_t)r * W * C + e, sizeof(D));
      }
    }
  } else {
    for (int q0 = threadIdx.x >> 5; q0 < n; q0 += kLoadBatch * warps) {
      int at[kLoadBatch];
      D v[kLoadBatch];
#pragma unroll
      for (int j = 0; j < kLoadBatch; ++j) {
        const int q = q0 + j * warps;
        const int r = __float2int_rz((q + 0.5f) * inv_pieces);
        const int e = (q - r * pieces) * 32 + lane;
        at[j] = q < n && e < row_len ? r * pitch + e : -1;
        if (at[j] >= 0) v[j] = ld(src, (int64_t)r * W * C + e);
      }
#pragma unroll
      for (int j = 0; j < kLoadBatch; ++j) {
        if (at[j] >= 0) dst[at[j]] = v[j];
      }
    }
  }
}

constexpr int kTH = 16;  // backward tile: rows
constexpr int kTW = 32;  // and columns of input pixels, one thread each; a warp is a row
constexpr int kTileThreads = kTH * kTW;
constexpr int kImgH = kTH + 4, kImgW = kTW + 4;  // target and candidate: halo 2
constexpr int kOutH = kTH + 2, kOutW = kTW + 2;  // outputs that read the tile: halo 1
constexpr int kOut = kOutH * kOutW;

// Transpose-window sum at u of one coefficient map m (already offset to
// its channel; lo is u's index in the output tile): the 3x3 outputs around
// u, row-major, output j weighted by w[j].
__device__ __forceinline__ float box_t(const float* m, int lo, int C, const float w[9]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 9; ++j) s += w[j] * m[(lo + (j / 3 - 1) * kOutW + j % 3 - 1) * C];
  return s;
}

// The whole backward: grid (W / kTW, H / kTH, B) tiles, one thread per input
// pixel of the tile, looping over channels. The visited candidates (those
// of grad_mask; all K when dt != nullptr; 1 <= K <= 31, which the caller
// checks) are all staged at once, in order. kC > 0 fixes the
// channel count at compile time (C = 3, the images' case: the channel
// loops unroll and every shared-memory offset is a constant); kC == 0
// takes C_ at run time.
template <typename T, int kC>
__global__ void __launch_bounds__(kTileThreads, 2)
bwd_tile_kernel(const T* __restrict__ tgt, const T* __restrict__ preds,
                const float* __restrict__ g, const int* __restrict__ idx,
                T* __restrict__ dp, T* __restrict__ dt, int K, int H, int W, int C_,
                unsigned grad_mask) {
  const int C = kC > 0 ? kC : C_;
  extern __shared__ float smem[];
  const bool need_dt = dt != nullptr;
  const unsigned visit = (need_dt ? 0xffffffffu : grad_mask) & ((1u << K) - 1u);
  const int img = kImgH * kImgW * C;
  const int pitch = kImgW * C;
  // candidate k's tile among the visited ones
  auto slot = [visit](int k) { return __popc(visit & ((1u << k) - 1u)); };
  float* y_s = smem;                                     // target, halo 2
  float* x_s = y_s + img;                                // visited candidates, halo 2
  float* g_s = x_s + __popc(visit) * img;                // g, halo 1
  int* idx_s = reinterpret_cast<int*>(g_s + kOut);       // idx, halo 1
  float* ca = reinterpret_cast<float*>(idx_s + kOut);    // maps A, B, G, A2: (o, c)
  float* cb = ca + kOut * C;
  float* cg = cb + kOut * C;
  float* ca2 = cg + kOut * C;                            // target gradient only
  float* out_s = ca2 + (need_dt ? kOut * C : 0);         // (u, c): a warp's row of dp_k
  float* dt_s = out_s + kTileThreads * C;                // target gradient only: (u, c)

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int t = threadIdx.x, lane = t & 31;
  const int uy = y0 + t / kTW, ux = x0 + lane;
  const bool live = uy < H && ux < W;
  const int64_t HW = (int64_t)H * W;
  // this warp's row of the tile: row_len contiguous elements from row_off
  const int row_len = uy < H ? min(kTW, W - x0) * C : 0;
  const int64_t row_off = ((int64_t)uy * W + x0) * C;
  float* warp_out = out_s + (t - lane) * C;

  for (int k = 0; k < K; ++k) {  // candidates without a gradient here: zeros
    if ((visit >> k) & 1u) continue;
    T* dp_row = dp + ((int64_t)b * K + k) * HW * C + row_off;
    for (int e = lane; e < row_len; e += 32) st(dp_row, e, 0.f);
  }
  if (need_dt) {
    for (int c = 0; c < C; ++c) dt_s[t * C + c] = 0.f;
  }

  const int lu = (t / kTW + 2) * pitch + (lane + 2) * C;  // u in the image tiles
  const int lo = (t / kTW + 1) * kOutW + lane + 1;        // u in the output tile
  // the reflect-pad fold: output uy - 1 reads row uy twice when uy == 1,
  // output uy + 1 when uy == H - 2; the same for columns
  const float wr0 = uy == 1 ? 2.f : 1.f, wr2 = uy == H - 2 ? 2.f : 1.f;
  const float wc0 = ux == 1 ? 2.f : 1.f, wc2 = ux == W - 2 ? 2.f : 1.f;
  const float two9 = 2.f / 9.f, ninth = 1.f / 9.f;

  load_tile(tgt + b * HW * C, y_s, H, W, C, y0, x0, kTH, kTW, 2);
  load_tile(g + b * HW, g_s, H, W, 1, y0, x0, kTH, kTW, 1);
  load_tile(idx + b * HW, idx_s, H, W, 1, y0, x0, kTH, kTW, 1);
  for (unsigned m = visit; m != 0u; m &= m - 1u) {
    const int k = __ffs(m) - 1;
    load_tile(preds + ((int64_t)b * K + k) * HW * C, x_s + slot(k) * img, H, W, C, y0, x0, kTH,
              kTW, 2);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // coefficient maps at every output of the halo-1 tile, of the candidate
  // the output selected when that is visited, else zero
  for (int i = t; i < kOut; i += kTileThreads) {
    const int oy = y0 - 1 + i / kOutW, ox = x0 - 1 + i % kOutW;
    const int k = oy >= 0 && oy < H && ox >= 0 && ox < W ? idx_s[i] : -1;
    if (k < 0 || k >= K || !((visit >> k) & 1u)) {
      for (int c = 0; c < C; ++c) {
        ca[i * C + c] = cb[i * C + c] = cg[i * C + c] = 0.f;
        if (need_dt) ca2[i * C + c] = 0.f;
      }
      continue;
    }
    const float* x_k = x_s + slot(k) * img;
    int rows[3], cols[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      rows[d] = (reflect(oy + d - 1, H) - y0 + 2) * pitch;
      cols[d] = (reflect(ox + d - 1, W) - x0 + 2) * C;
    }
    const float g_o = g_s[i] * (-0.425f / C);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float sx = 0.f, sy = 0.f, sxx = 0.f, syy = 0.f, sxy = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const int off = rows[di] + cols[dj] + c;
          const float a = x_k[off];
          const float v = y_s[off];
          sx += a;
          sy += v;
          sxx += a * a;
          syy += v * v;
          sxy += a * v;
        }
      }
      const float mu_x = sx * ninth, mu_y = sy * ninth;
      const float n1 = 2.f * mu_x * mu_y + kC1;
      const float n2 = 2.f * (sxy * ninth - mu_x * mu_y) + kC2;
      const float d1 = mu_x * mu_x + mu_y * mu_y + kC1;
      const float d2 = (sxx * ninth - mu_x * mu_x) + (syy * ninth - mu_y * mu_y) + kC2;
      const float n = n1 * n2;
      const float inv_d = 1.f / (d1 * d2);
      const float s_raw = (1.f - n * inv_d) * 0.5f;
      const float Qn = s_raw > 0.f && s_raw < 1.f ? g_o * inv_d : 0.f;
      const float Qd = -Qn * n * inv_d;
      const int q = i * C + c;
      ca[q] = two9 * (Qn * mu_y * (n2 - n1) + Qd * mu_x * (d2 - d1));
      cb[q] = two9 * Qn * n1;
      cg[q] = two9 * Qd * d1;
      if (need_dt) ca2[q] = two9 * (Qn * mu_x * (n2 - n1) + Qd * mu_y * (d2 - d1));
    }
  }
  __syncthreads();

  // gather, candidate by candidate: u's transpose windows over the
  // outputs that selected k, the robust-L1 term, then the warp writes its
  // row of dp_k
  const int k_u = live ? idx_s[lo] : -1;
  const float l1_g = live ? g_s[lo] * (0.15f / C) : 0.f;
  for (unsigned m = visit; m != 0u; m &= m - 1u) {
    const int k = __ffs(m) - 1;
    if (live) {
      const float* x_k = x_s + slot(k) * img;
      float w[9];  // each output's tap count onto u, zero unless it selected k
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const float wj = (j / 3 == 0 ? wr0 : j / 3 == 2 ? wr2 : 1.f) *
                         (j % 3 == 0 ? wc0 : j % 3 == 2 ? wc2 : 1.f);
        w[j] = idx_s[lo + (j / 3 - 1) * kOutW + j % 3 - 1] == k ? wj : 0.f;
      }
      const bool grad = (grad_mask >> k) & 1u;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float sa = box_t(ca + c, lo, C, w);
        const float sb = box_t(cb + c, lo, C, w);
        const float sg = box_t(cg + c, lo, C, w);
        const float xv = x_k[lu + c], yv = y_s[lu + c];
        float l1 = 0.f;
        if (k_u == k) {
          const float diff = xv - yv;
          l1 = l1_g * diff / sqrtf(diff * diff + 1e-6f);
        }
        out_s[t * C + c] = grad ? sa + yv * sb + xv * sg + l1 : 0.f;
        if (need_dt) {
          const float sa2 = box_t(ca2 + c, lo, C, w);
          dt_s[t * C + c] += sa2 + xv * sb + yv * sg - l1;
        }
      }
    }
    __syncwarp();
    T* dp_row = dp + ((int64_t)b * K + k) * HW * C + row_off;
    for (int e = lane; e < row_len; e += 32) st(dp_row, e, warp_out[e]);
    __syncwarp();
  }

  if (need_dt) {
    T* dt_row = dt + b * HW * C + row_off;
    for (int e = lane; e < row_len; e += 32) st(dt_row, e, dt_s[(t - lane) * C + e]);
  }
}

inline unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <typename T>
int launch_fwd(const void* tgt, const void* preds, void* out, void* idx, int B,
               int K, int H, int W, int C, cudaStream_t stream) {
  const int64_t n = (int64_t)B * H * W;
  fwd_kernel<T><<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<const T*>(tgt), static_cast<const T*>(preds),
      static_cast<float*>(out), static_cast<int*>(idx), B, K, H, W, C);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one backward block: the target and the visited
// candidates (halo 2), g and idx (halo 1), the coefficient maps and the
// row buffers.
size_t bwd_block_smem(int K, int C, unsigned grad_mask, bool need_dt) {
  const unsigned visit = (need_dt ? 0xffffffffu : grad_mask) & ((1u << K) - 1u);
  const size_t img = (size_t)kImgH * kImgW * C;
  const size_t maps = (need_dt ? 4 : 3) * (size_t)kOut * C;
  const size_t rows = (need_dt ? 2 : 1) * (size_t)kTileThreads * C;  // out_s, dt_s
  return ((1 + __builtin_popcount(visit)) * img + 2 * kOut + maps + rows) * sizeof(float);
}

template <typename T>
int launch_bwd(const void* tgt, const void* preds, const void* g, const void* idx, void* dp,
               void* dt, int B, int K, int H, int W, int C, unsigned grad_mask,
               cudaStream_t stream) {
  const size_t smem = bwd_block_smem(K, C, grad_mask, dt != nullptr);
  auto kernel = C == 3 ? bwd_tile_kernel<T, 3> : bwd_tile_kernel<T, 0>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  kernel<<<grid, kTileThreads, smem, stream>>>(
      static_cast<const T*>(tgt), static_cast<const T*>(preds),
      static_cast<const float*>(g), static_cast<const int*>(idx), static_cast<T*>(dp),
      static_cast<T*>(dt), K, H, W, C, grad_mask);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward: out (B, H, W) float32 min loss, idx (B, H, W) int32 argmin.
// Returns the cudaError_t of the launch.
extern "C" int photometric_fwd(const void* tgt, const void* preds, void* out, void* idx,
                               int B, int K, int H, int W, int C, int is_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(tgt, preds, out, idx, B, K, H, W, C, s)
                 : launch_fwd<float>(tgt, preds, out, idx, B, K, H, W, C, s);
}

// Backward: g (B, H, W) float32, idx (B, H, W) int32 from the forward,
// dp (B, K, H, W, C) and dt (B, H, W, C, or null when the target gradient
// is not needed) in the input dtype. Bit k of grad_mask set = candidate k
// gets a gradient; the others get zeros. One launch; returns its
// cudaError_t.
extern "C" int photometric_bwd(const void* tgt, const void* preds, const void* g,
                               const void* idx, void* dp, void* dt, int B, int K, int H,
                               int W, int C, int grad_mask, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned mask = static_cast<unsigned>(grad_mask);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(tgt, preds, g, idx, dp, dt, B, K, H, W, C,
                                             mask, s)
                 : launch_bwd<float>(tgt, preds, g, idx, dp, dt, B, K, H, W, C, mask, s);
}

// Bytes of dynamic shared memory a backward block takes (ptxas reports
// only static shared memory).
extern "C" int photometric_bwd_smem(int K, int C, int grad_mask, int need_dt) {
  return (int)bwd_block_smem(K, C, static_cast<unsigned>(grad_mask), need_dt != 0);
}
