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
// Forward, one launch, in place of _forward_tiled (:200). A block owns a
// kFH x kFW = 32 x 32 tile of outputs; each thread owns one column of a
// strip of kFR = 4 rows, so a warp is 32 consecutive columns and its
// shared-memory reads of the NHWC tiles (a stride of C = 3 words) hit 32
// distinct banks. The tiles are staged with a halo of 1: float rows that
// start on 16-byte boundaries (W * C a multiple of 4, as at every preset's
// width) in 16-byte cp.async copies (load_tile16), other float images in
// 4-byte ones and bf16 widened through registers (load_tile); their reflect
// padding is filled from the reflected pixels, so every tap lies at a fixed
// offset from the thread's first. The target's tile is staged once and its
// window mean and variance are computed once per output into shared memory
// (C = 3; the run-time-C instance recomputes them per candidate). The
// candidates stream through a two-slot ring, candidate k + 1's copies in
// flight while candidate k is computed, one barrier per candidate, so
// shared memory does not depend on K: 68,652 B a block at C = 3, three
// blocks of 256 threads an SM (at most 85 registers). A thread reads each
// tile row of its strip once (three taps of x and of y per channel), forms
// the row's products and sums once, and slides the 3x3 window down the
// strip in registers; the running min and argmin stay in registers (strict
// <), and each warp stores 32 consecutive pixels.
//
// The window sums are taken in the order of the plain version (avg_pool2d)
// and of the Pallas kernel's _kernel: the nine taps row by row, products
// rounded, the mean a division by 9 rounded to nearest, no contraction of a
// product into a sum. So the kernel rounds as they do, about 1e-8 from the
// plain version at the flagship shape; sums taken separably (row sums, then
// a sum of three) came to the tests' 1e-5 limit from it there, because
// E[x^2] - mu^2 cancels in low-contrast windows.
//
// What bounds the forward: at the flagship shape (B=12, K=4, 320x1024, C=3,
// f32) it must move 267 MB (0.080 ms at 3.35 TB/s). Summing in that order
// costs about 70 f32 operations per (pixel, candidate, channel), some
// 0.11 ms of f32 issue over 132 SMs at 1.755 GHz before the loads, the
// staging and the integer work beside them. So issue, not memory, bounds
// it: 0.24 ms on an H100 SXM at 700 W.
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

constexpr float kC1 = 1e-4f;  // 0.01^2 and 0.03^2 rounded to float once, as the
constexpr float kC2 = 9e-4f;  // plain version and the Pallas kernel round them

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

// Stages rows [y0 - halo, y0 + th + halo) and columns [x0 - halo,
// x0 + tw + halo) of one (H, W, C) image, clipped to the image, into a
// shared-memory tile of row pitch `pitch` (at least (tw + 2 * halo) * C)
// whose first element is pixel (y0 - halo, x0 - halo); positions outside
// the image are left unwritten. A copy between types of one size (float,
// int) is asynchronous, each warp taking whole rows in turn, lane i every
// 32nd element from i: the caller ends its loads with __pipeline_commit()
// and __pipeline_wait_prior(0) before __syncthreads(), so every load of
// every tile is in flight at once. bf16 is widened to float through
// registers in 32-element pieces of rows spread over the warps, kLoadBatch
// loads in flight per thread. blockDim.x is a multiple of 32.
constexpr int kLoadBatch = 8;

template <typename S, typename D>
__device__ __forceinline__ void load_tile(const S* __restrict__ img, D* __restrict__ tile,
                                          int H, int W, int C, int y0, int x0, int th,
                                          int tw, int halo, int pitch) {
  const int r0 = max(y0 - halo, 0), r1 = min(y0 + th + halo, H);
  const int c0 = max(x0 - halo, 0), c1 = min(x0 + tw + halo, W);
  const int row_len = (c1 - c0) * C;
  D* dst = tile + (r0 - y0 + halo) * pitch + (c0 - x0 + halo) * C;
  const S* src = img + ((int64_t)r0 * W + c0) * C;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  if constexpr (sizeof(S) == sizeof(D)) {
    for (int r = threadIdx.x >> 5; r < r1 - r0; r += warps) {
      D* d = dst + r * pitch;
      const S* s = src + (int64_t)r * W * C;
      for (int e = lane; e < row_len; e += 32) __pipeline_memcpy_async(d + e, s + e, sizeof(D));
    }
  } else {
    const int pieces = (row_len + 31) / 32;  // per row
    const float inv_pieces = 1.f / pieces;   // q / pieces below, exact for q < 2^20
    const int n = (r1 - r0) * pieces;
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

// The rows and columns load_tile stages with a halo of 1, for a float image
// whose rows start on 16-byte boundaries (W * C a multiple of 4, the image
// 16-byte aligned), in 16-byte copies: each row's copy starts at the 16-byte
// boundary at or before its first float and ends at the one at or after its
// last, so up to 3 floats on either side land outside the row's pixels. The
// caller's tile has room for them (the row pitch spares 6 floats), and its
// first element sits (x0 - 1) * C floats from a 16-byte boundary, mod 4,
// so that both ends of every copy are aligned.
__device__ __forceinline__ void load_tile16(const float* __restrict__ img, float* __restrict__ tile,
                                            int H, int W, int C, int y0, int x0, int th, int tw,
                                            int pitch) {
  const int r0 = max(y0 - 1, 0), r1 = min(y0 + th + 1, H);
  const int c0 = max(x0 - 1, 0), c1 = min(x0 + tw + 1, W);
  const int lead = (c0 * C) & 3;  // floats from the boundary to the row's first
  const int n4 = ((c1 - c0) * C + lead + 3) >> 2;
  float* dst = tile + (r0 - y0 + 1) * pitch + (c0 - x0 + 1) * C - lead;
  const float* src = img + ((int64_t)r0 * W + c0) * C - lead;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < r1 - r0; r += warps) {
    for (int q = lane; q < n4; q += 32) {
      __pipeline_memcpy_async(dst + r * pitch + 4 * q, src + (int64_t)r * W * C + 4 * q, 16);
    }
  }
}

// Fills the positions of a halo-1 tile, as load_tile stages it, that lie on
// the reflect padding: row -1 from row 1, row H from row H - 2, column -1
// from column 1 and column W from column W - 2, corners both ways. Only
// tiles at the image's border have any. Float copies join the caller's
// pipeline group as load_tile's do; bf16 is widened through registers.
template <typename S>
__device__ __forceinline__ void load_reflect_pad(const S* __restrict__ img, float* __restrict__ tile,
                                                 int H, int W, int C, int y0, int x0, int th,
                                                 int tw, int pitch) {
  const int c0 = max(x0 - 1, -1), c1 = min(x0 + tw + 1, W + 1);  // tile columns in the padded image
  const int r0 = max(y0 - 1, -1), r1 = min(y0 + th + 1, H + 1);
  auto copy = [&](int r, int col, int c) {
    float* dst = tile + (r - y0 + 1) * pitch + (col - x0 + 1) * C + c;
    const S* src = img + ((int64_t)reflect(r, H) * W + reflect(col, W)) * C + c;
    if constexpr (sizeof(S) == sizeof(float)) {
      __pipeline_memcpy_async(dst, src, sizeof(float));
    } else {
      *dst = ld(src, 0);
    }
  };
  const int row_n = (c1 - c0) * C;
  for (int i = 0; i < 2; ++i) {  // padded rows, every column of the tile
    const int r = i ? H : -1;
    if (r < r0 || r >= r1) continue;
    for (int e = threadIdx.x; e < row_n; e += blockDim.x) copy(r, c0 + e / C, e % C);
  }
  const int col_n = (min(r1, H) - max(r0, 0)) * C;
  for (int i = 0; i < 2; ++i) {  // padded columns, the image's rows of the tile
    const int col = i ? W : -1;
    if (col < c0 || col >= c1) continue;
    for (int e = threadIdx.x; e < col_n; e += blockDim.x) copy(max(r0, 0) + e / C, col, e % C);
  }
}

// Forward tile: kFW columns (a warp's lanes) by kFH rows of outputs; each
// thread owns one column of a strip of kFR rows.
constexpr int kFW = 32;
constexpr int kFH = 32;
constexpr int kFR = 4;
constexpr int kFwdThreads = kFW * kFH / kFR;
constexpr int kFwdMinBlocks = 3;   // an SM, as shared memory allows at C = 3: <= 85 registers
constexpr int kFTile = kFH * kFW;  // outputs of a tile, the stride of a channel's statistics
constexpr float kNinth = 1.f / 9.f;

// The forward's tile row pitch in floats: the halo-1 row of C-float pixels,
// 6 floats to spare for load_tile16's ends, a multiple of 4.
__host__ __device__ constexpr int fwd_pitch(int C) { return ((kFW + 2) * C + 6 + 3) & ~3; }

// Arithmetic that rounds as the plain version's separate tensor operations
// do: no contraction of a product into a sum.
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// s / 9 rounded to nearest, as a division rounds it: s * (1/9) and one
// exact-residual correction.
__device__ __forceinline__ float div9(float s) {
  const float q = s * kNinth;
  return fmaf(fmaf(-q, 9.f, s), kNinth, q);
}

// n / d for a positive, normal d (here at least C1 * C2): the approximate
// reciprocal and one exact-residual correction, with no slow path.
__device__ __forceinline__ float div_pos(float n, float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  const float q = n * r;
  return fmaf(fmaf(-q, d, n), r, q);
}

// The robust-L1 term's square root to about an ulp, one MUFU operation; its
// error, weighted by 0.15 / C, stays below 1e-8.
__device__ __forceinline__ float sqrt_approx(float v) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// A 3x3 window's sum in row-major order, the order in which the plain
// version (avg_pool2d) and the Pallas kernel add its taps: the top row's
// sum, then the middle and bottom rows' taps one by one.
__device__ __forceinline__ float window_sum(float top, const float (&mid)[3],
                                            const float (&bot)[3]) {
  float s = top;
#pragma unroll
  for (int t = 0; t < 3; ++t) s = add(s, mid[t]);
#pragma unroll
  for (int t = 0; t < 3; ++t) s = add(s, bot[t]);
  return s;
}

__device__ __forceinline__ float row_sum(const float (&v)[3]) { return add(add(v[0], v[1]), v[2]); }

// The target's window mean and variance over a thread's strip, one
// channel: y is the thread's first tap (top-left of output 0's window) in
// the target tile, at the channel; mu and sig (stride kFW) receive one
// value per output.
__device__ __forceinline__ void target_stats(const float* __restrict__ y, int pitch, int C,
                                             float* __restrict__ mu, float* __restrict__ sig) {
  float v[3][3], vv[3][3], h[3], hh[3];  // slot r % 3: row r's taps, squares and sums
#pragma unroll
  for (int r = 0; r < kFR + 2; ++r) {
    const int s = r % 3, top = (r + 1) % 3, mid = (r + 2) % 3;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      v[s][t] = y[r * pitch + t * C];
      vv[s][t] = mul(v[s][t], v[s][t]);
    }
    h[s] = row_sum(v[s]);
    hh[s] = row_sum(vv[s]);
    if (r < 2) continue;
    const float m = div9(window_sum(h[top], v[mid], v[s]));
    mu[(r - 2) * kFW] = m;
    sig[(r - 2) * kFW] = add(div9(window_sum(hh[top], vv[mid], vv[s])), -mul(m, m));
  }
}

// Adds one channel's SSIM and robust-L1 terms of candidate x over a
// thread's strip to ssim_sum and l1_sum. x and y are the thread's first tap
// in the candidate and target tiles, at the channel; mu and sig the
// target's statistics (stride kFW), or with kOwnStats computed here. Each
// tile row's taps are read once (three of x, three of y); products and the
// top row's sum are formed once per row and shared by the three windows
// that hold the row.
template <bool kOwnStats>
__device__ __forceinline__ void candidate_terms(const float* __restrict__ x,
                                                const float* __restrict__ y, int pitch, int C,
                                                const float* __restrict__ mu,
                                                const float* __restrict__ sig,
                                                float (&ssim_sum)[kFR], float (&l1_sum)[kFR]) {
  // slot r % 3: row r's taps, products and row sums
  float a[3][3], aa[3][3], ab[3][3], b[3][3], bb[3][3], h[3], hh[3], hab[3], hb[3], hbb[3];
#pragma unroll
  for (int r = 0; r < kFR + 2; ++r) {
    const int s = r % 3, top = (r + 1) % 3, mid = (r + 2) % 3, j = r - 2;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      b[s][t] = y[r * pitch + t * C];
      a[s][t] = x[r * pitch + t * C];
      aa[s][t] = mul(a[s][t], a[s][t]);
      ab[s][t] = mul(a[s][t], b[s][t]);
      if (kOwnStats) bb[s][t] = mul(b[s][t], b[s][t]);
    }
    h[s] = row_sum(a[s]);
    hh[s] = row_sum(aa[s]);
    hab[s] = row_sum(ab[s]);
    if (kOwnStats) {
      hb[s] = row_sum(b[s]);
      hbb[s] = row_sum(bb[s]);
    }
    if (r < 2) continue;
    const float mu_x = div9(window_sum(h[top], a[mid], a[s]));
    const float e_xx = div9(window_sum(hh[top], aa[mid], aa[s]));
    const float e_xy = div9(window_sum(hab[top], ab[mid], ab[s]));
    float mu_y, sig_y;
    if constexpr (kOwnStats) {
      mu_y = div9(window_sum(hb[top], b[mid], b[s]));
      sig_y = add(div9(window_sum(hbb[top], bb[mid], bb[s])), -mul(mu_y, mu_y));
    } else {
      mu_y = mu[j * kFW];
      sig_y = sig[j * kFW];
    }
    const float mxx = mul(mu_x, mu_x), mxy = mul(mu_x, mu_y), myy = mul(mu_y, mu_y);
    const float sig_x = add(e_xx, -mxx), sig_xy = add(e_xy, -mxy);
    // 2 * m is exact, so each fmaf rounds as the plain version's 2 * m + c does
    const float num = mul(fmaf(2.f, mxy, kC1), fmaf(2.f, sig_xy, kC2));
    const float den = mul(add(add(mxx, myy), kC1), add(add(sig_x, sig_y), kC2));
    ssim_sum[j] = add(ssim_sum[j], __saturatef(mul(add(1.f, -div_pos(num, den)), 0.5f)));
    const float diff = add(b[mid][1], -a[mid][1]);
    l1_sum[j] = add(l1_sum[j], sqrt_approx(add(mul(diff, diff), 1e-6f)));
  }
}

// The whole forward: grid (W / kFW, H / kFH, B) tiles. The target's tile is
// staged once and its window statistics computed once; the candidates
// stream through a two-slot ring, candidate k + 1's copies in flight while
// candidate k is computed, so shared memory does not depend on K. kC > 0
// fixes the channel count at compile time (C = 3, every preset); kC == 0
// takes C_ at run time.
template <typename T, int kC>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
fwd_tile_kernel(const T* __restrict__ tgt, const T* __restrict__ preds, float* __restrict__ out,
                int* __restrict__ idx, int K, int H, int W, int C_) {
  const int C = kC > 0 ? kC : C_;
  extern __shared__ float smem[];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kFH, x0 = blockIdx.x * kFW;
  const int pitch = fwd_pitch(C);
  const int img = (kFH + 2) * pitch;
  // each tile's first element sits (x0 - 1) * C floats past a 16-byte
  // boundary, mod 4, as load_tile16 needs
  float* y_s = smem + (((x0 - 1) * C) & 3);  // target, halo 1, reflect padding filled
  float* ring = y_s + img;                    // two candidate slots, the same
  float* mu_s = ring + 2 * img;               // C = 3: target window means (c, row, column)
  float* sig_s = mu_s + kFTile * C;           // and variances
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * kFR;
  const int oy0 = y0 + row0, ox = x0 + lane;
  const int64_t HW = (int64_t)H * W;
  // the thread's first tap, top-left of output row0's window; outputs past
  // the image read what their tile holds there and are not stored
  const int tap0 = row0 * pitch + lane * C;
  const int stat0 = row0 * kFW + lane;

  const T* cand = preds + (int64_t)b * K * HW * C;
  bool rows16 = false;  // float rows that start on 16-byte boundaries
  if constexpr (sizeof(T) == sizeof(float)) {
    rows16 = (W * C) % 4 == 0 && ((reinterpret_cast<uintptr_t>(tgt) |
                                   reinterpret_cast<uintptr_t>(preds)) & 15) == 0;
  }
  auto stage = [&](const T* src, float* tile) {
    if constexpr (sizeof(T) == sizeof(float)) {
      if (rows16) load_tile16(src, tile, H, W, C, y0, x0, kFH, kFW, pitch);
    }
    if (!rows16) load_tile(src, tile, H, W, C, y0, x0, kFH, kFW, 1, pitch);
    load_reflect_pad(src, tile, H, W, C, y0, x0, kFH, kFW, pitch);
    __pipeline_commit();
  };
  stage(tgt + b * HW * C, y_s);
  stage(cand, ring);
  __pipeline_wait_prior(1);
  __syncthreads();
  // the target's statistics while candidate 0 lands; each thread reads
  // back only its own, so no barrier follows
  if constexpr (kC > 0) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      target_stats(y_s + tap0 + c, pitch, C, mu_s + c * kFTile + stat0,
                   sig_s + c * kFTile + stat0);
    }
  }

  const float inv_c = 1.f / C;
  float best[kFR];
  int best_k[kFR];
#pragma unroll
  for (int j = 0; j < kFR; ++j) {
    best[j] = INFINITY;
    best_k[j] = 0;
  }
  for (int k = 0; k < K; ++k) {
    __pipeline_wait_prior(0);
    __syncthreads();  // candidate k has landed, and every thread is done with k - 1's slot
    if (k + 1 < K) stage(cand + (k + 1) * HW * C, ring + ((k + 1) & 1) * img);
    const float* x_s = ring + (k & 1) * img;
    float ssim_sum[kFR], l1_sum[kFR];
#pragma unroll
    for (int j = 0; j < kFR; ++j) ssim_sum[j] = l1_sum[j] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {  // unrolled for kC = 3
      candidate_terms<kC == 0>(x_s + tap0 + c, y_s + tap0 + c, pitch, C,
                               mu_s + c * kFTile + stat0, sig_s + c * kFTile + stat0, ssim_sum,
                               l1_sum);
    }
#pragma unroll
    for (int j = 0; j < kFR; ++j) {
      // the channel means, weighted, as the plain version combines them
      const float loss = add(mul(0.85f, mul(ssim_sum[j], inv_c)), mul(0.15f, mul(l1_sum[j], inv_c)));
      if (loss < best[j]) {  // strict: on a tie the first candidate stays
        best[j] = loss;
        best_k[j] = k;
      }
    }
  }

  if (ox >= W) return;
  float* out_b = out + b * HW;
  int* idx_b = idx + b * HW;
#pragma unroll
  for (int j = 0; j < kFR; ++j) {
    if (oy0 + j < H) {
      out_b[(int64_t)(oy0 + j) * W + ox] = best[j];
      idx_b[(int64_t)(oy0 + j) * W + ox] = best_k[j];
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

  load_tile(tgt + b * HW * C, y_s, H, W, C, y0, x0, kTH, kTW, 2, pitch);
  load_tile(g + b * HW, g_s, H, W, 1, y0, x0, kTH, kTW, 1, kOutW);
  load_tile(idx + b * HW, idx_s, H, W, 1, y0, x0, kTH, kTW, 1, kOutW);
  for (unsigned m = visit; m != 0u; m &= m - 1u) {
    const int k = __ffs(m) - 1;
    load_tile(preds + ((int64_t)b * K + k) * HW * C, x_s + slot(k) * img, H, W, C, y0, x0, kTH,
              kTW, 2, pitch);
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

// Dynamic shared memory of one forward block: the target and two candidate
// slots, each kFH + 2 rows of fwd_pitch(C) floats after up to 3 floats of
// alignment, and for C = 3 the target's window mean and variance at each
// output (the run-time-C instance recomputes them per candidate).
// Independent of K.
size_t fwd_block_smem(int C) {
  const size_t stats = C == 3 ? 2 * (size_t)kFTile * C : 0;
  return (3 * (size_t)(kFH + 2) * fwd_pitch(C) + 3 + stats) * sizeof(float);
}

template <typename T>
int launch_fwd(const void* tgt, const void* preds, void* out, void* idx, int B, int K, int H,
               int W, int C, cudaStream_t stream) {
  const size_t smem = fwd_block_smem(C);
  auto kernel = C == 3 ? fwd_tile_kernel<T, 3> : fwd_tile_kernel<T, 0>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((W + kFW - 1) / kFW, (H + kFH - 1) / kFH, B);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(tgt), static_cast<const T*>(preds), static_cast<float*>(out),
      static_cast<int*>(idx), K, H, W, C);
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

// Bytes of dynamic shared memory a forward or backward block takes
// (ptxas reports only static shared memory).
extern "C" int photometric_fwd_smem(int C) { return (int)fwd_block_smem(C); }

extern "C" int photometric_bwd_smem(int K, int C, int grad_mask, int need_dt) {
  return (int)bwd_block_smem(K, C, static_cast<unsigned>(grad_mask), need_dt != 0);
}
