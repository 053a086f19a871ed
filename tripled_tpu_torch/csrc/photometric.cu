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
// stage a (rows+2) x (cols+2) halo tile in shared memory, compute the box
// sums separably, and vectorise the channel loads.
//
// Backward, deterministic gather form (no atomics, so two runs give the
// same bits): pass 1 writes, for every output pixel and channel, the four
// SSIM coefficient maps A, B, G, A2 of the selected candidate (see
// _backward_tiled's docstring); pass 2 gives every input element the
// transpose-window sum of those maps over the padded positions that
// reflect onto it, plus the local robust-L1 term, so the reflect-pad fold
// happens in the gather itself. Pruned candidates (outside grad_mask) get
// zeros. The coefficient scratch costs 16 B per pixel and channel of extra
// traffic that a fused single-pass version with a shared-memory halo would
// not need.

#include <cuda_bf16.h>
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

// Pass 1: coefficient maps (A, B, G, A2) per output pixel and channel for
// the selected candidate, scaled by the incoming gradient. Pixels whose
// candidate is outside loop_mask are skipped: pass 2 never reads them.
template <typename T>
__global__ void bwd_coef_kernel(const T* __restrict__ tgt, const T* __restrict__ preds,
                                const float* __restrict__ g, const int* __restrict__ idx,
                                float4* __restrict__ coef, int B, int K, int H, int W,
                                int C, unsigned loop_mask) {
  const int64_t HW = (int64_t)H * W;
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B * HW * C) return;
  const int c = (int)(q % C);
  const int64_t p = q / C;
  const int k = idx[p];
  if (k < 0 || k >= K || !((loop_mask >> k) & 1u)) return;
  const int b = (int)(p / HW);
  const int rem = (int)(p - b * HW);
  const int oy = rem / W;
  const int ox = rem - oy * W;
  const T* x = preds + ((int64_t)b * K + k) * HW * C;
  const T* y = tgt + b * HW * C;

  const Stats s = window_stats(x, y, H, W, C, oy, ox, c);
  const float n1 = 2.f * s.mu_x * s.mu_y + kC1;
  const float n2 = 2.f * (s.sxy - s.mu_x * s.mu_y) + kC2;
  const float d1 = s.mu_x * s.mu_x + s.mu_y * s.mu_y + kC1;
  const float d2 = (s.sxx - s.mu_x * s.mu_x) + (s.syy - s.mu_y * s.mu_y) + kC2;
  const float n = n1 * n2;
  const float d = d1 * d2;
  const float s_raw = (1.f - n / d) * 0.5f;
  const bool in_range = s_raw > 0.f && s_raw < 1.f;
  const float P = in_range ? g[p] * (-0.425f / C) : 0.f;
  const float Qn = P / d;
  const float Qd = -P * n / (d * d);
  const float two9 = 2.f / 9.f;
  coef[q] = make_float4(two9 * (Qn * s.mu_y * (n2 - n1) + Qd * s.mu_x * (d2 - d1)),
                        two9 * Qn * n1, two9 * Qd * d1,
                        two9 * (Qn * s.mu_x * (n2 - n1) + Qd * s.mu_y * (d2 - d1)));
}

// Padded rows (or columns) whose reflection lands on real index r: r + 1,
// plus 0 when r == 1, plus n + 1 when r == n - 2. Returns how many.
__device__ __forceinline__ int padded_sources(int r, int n, int out[3]) {
  int m = 0;
  out[m++] = r + 1;
  if (r == 1) out[m++] = 0;
  if (r == n - 2) out[m++] = n + 1;
  return m;
}

// Pass 2: one thread per input element (b, y, x, c).
template <typename T>
__global__ void bwd_grad_kernel(const T* __restrict__ tgt, const T* __restrict__ preds,
                                const float* __restrict__ g, const int* __restrict__ idx,
                                const float4* __restrict__ coef, T* __restrict__ dp,
                                T* __restrict__ dt, int B, int K, int H, int W, int C,
                                unsigned grad_mask) {
  const int64_t HW = (int64_t)H * W;
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B * HW * C) return;
  const int c = (int)(q % C);
  const int64_t p = q / C;
  const int b = (int)(p / HW);
  const int rem = (int)(p - b * HW);
  const int ry = rem / W;
  const int rx = rem - ry * W;
  const int64_t base = b * HW;  // pixel offset of image b
  const float yv = ld(tgt, q);
  const float l1_scale = 0.15f / C;

  int prow[3], pcol[3];
  const int nrow = padded_sources(ry, H, prow);
  const int ncol = padded_sources(rx, W, pcol);
  const int k_centre = idx[p];

  for (int k = 0; k < K; ++k) {
    const int64_t off = (((int64_t)b * K + k) * HW + rem) * C + c;
    if (!((grad_mask >> k) & 1u)) {
      st(dp, off, 0.f);
      continue;
    }
    const float xv = ld(preds, off);
    float sa = 0.f, sb = 0.f, sg = 0.f;
    for (int i = 0; i < nrow; ++i) {
      const int y0 = max(prow[i] - 2, 0), y1 = min(prow[i], H - 1);
      for (int j = 0; j < ncol; ++j) {
        const int x0 = max(pcol[j] - 2, 0), x1 = min(pcol[j], W - 1);
        for (int oy = y0; oy <= y1; ++oy) {
          for (int ox = x0; ox <= x1; ++ox) {
            const int64_t o = base + (int64_t)oy * W + ox;
            if (idx[o] == k) {
              const float4 cf = coef[o * C + c];
              sa += cf.x;
              sb += cf.y;
              sg += cf.z;
            }
          }
        }
      }
    }
    float v = sa + yv * sb + xv * sg;
    if (k_centre == k) {
      const float diff = xv - yv;
      v += g[p] * l1_scale * diff / sqrtf(diff * diff + 1e-6f);
    }
    st(dp, off, v);
  }

  if (dt == nullptr) return;
  float v = 0.f;
  for (int i = 0; i < nrow; ++i) {
    const int y0 = max(prow[i] - 2, 0), y1 = min(prow[i], H - 1);
    for (int j = 0; j < ncol; ++j) {
      const int x0 = max(pcol[j] - 2, 0), x1 = min(pcol[j], W - 1);
      for (int oy = y0; oy <= y1; ++oy) {
        for (int ox = x0; ox <= x1; ++ox) {
          const int64_t o = base + (int64_t)oy * W + ox;
          const int ko = idx[o];
          if (ko < 0 || ko >= K) continue;
          const float4 cf = coef[o * C + c];
          const float xo = ld(preds, (((int64_t)b * K + ko) * HW + rem) * C + c);
          v += cf.w + xo * cf.y + yv * cf.z;
        }
      }
    }
  }
  if (k_centre >= 0 && k_centre < K) {
    const float xv = ld(preds, (((int64_t)b * K + k_centre) * HW + rem) * C + c);
    const float diff = xv - yv;
    v -= g[p] * l1_scale * diff / sqrtf(diff * diff + 1e-6f);
  }
  st(dt, q, v);
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

template <typename T>
int launch_bwd(const void* tgt, const void* preds, const void* g, const void* idx,
               void* coef, void* dp, void* dt, int B, int K, int H, int W, int C,
               unsigned grad_mask, cudaStream_t stream) {
  const int64_t n = (int64_t)B * H * W * C;
  const unsigned loop_mask = dt != nullptr ? 0xffffffffu : grad_mask;
  bwd_coef_kernel<T><<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<const T*>(tgt), static_cast<const T*>(preds),
      static_cast<const float*>(g), static_cast<const int*>(idx),
      static_cast<float4*>(coef), B, K, H, W, C, loop_mask);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  bwd_grad_kernel<T><<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<const T*>(tgt), static_cast<const T*>(preds),
      static_cast<const float*>(g), static_cast<const int*>(idx),
      static_cast<const float4*>(coef), static_cast<T*>(dp), static_cast<T*>(dt), B,
      K, H, W, C, grad_mask);
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
// coef scratch (B*H*W*C) float4, dp (B, K, H, W, C) and dt (B, H, W, C, or
// null when the target gradient is not needed) in the input dtype. Bit k
// of grad_mask set = candidate k gets a gradient; the others get zeros.
// Returns the first cudaError_t of the two launches.
extern "C" int photometric_bwd(const void* tgt, const void* preds, const void* g,
                               const void* idx, void* coef, void* dp, void* dt, int B,
                               int K, int H, int W, int C, int grad_mask, int is_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned mask = static_cast<unsigned>(grad_mask);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(tgt, preds, g, idx, coef, dp, dt, B, K, H,
                                             W, C, mask, s)
                 : launch_bwd<float>(tgt, preds, g, idx, coef, dp, dt, B, K, H, W, C,
                                     mask, s);
}
