// The feed-forward's row passes, one warp per row, shared by the forward's
// bf16 route (fused_ff.cu) and the passes of fused_ff_bwd.cu (with the
// split route's products, declared below): y = LN(x)
// before fc1 (pre-norm), and the last pass that adds b2 to fc2's f32
// output, takes its LN (post-norm) and adds the residual. Rows are `ld`
// elements (ld >= c; the wrapper zero-pads a width that is not a multiple
// of 8), every statistic runs over the true width c, and the columns in
// [c, ld) of what a pass writes are zero.
#pragma once

#include "common.cuh"

// mean and rstd of V, an expression of the column k, over k < c: one warp per
// row, two passes (the mean, then the mean of squared deviations), the loops
// inline in each kernel; kEps is the including namespace's
#define ROW_STATS(V, c, mean, rstd)                          \
  do {                                                       \
    float s_ = 0.f;                                          \
    for (int k = lane; k < c; k += 32) s_ += (V);            \
    mean = warp_sum(s_) / c;                                 \
    float q_ = 0.f;                                          \
    for (int k = lane; k < c; k += 32) {                     \
      const float d_ = (V) - mean;                           \
      q_ += d_ * d_;                                         \
    }                                                        \
    rstd = rsqrtf(warp_sum(q_) / c + kEps);                  \
  } while (0)

namespace credit {
namespace ff {

constexpr float kEps = 1e-5f;
constexpr int ROW_THREADS = 256;  // 8 rows a block
constexpr int ROW_WARPS = ROW_THREADS / 32;

// The split route's two products (fused_ff.cu), which the backward's
// post-norm form recomputes (fused_ff_bwd.cu), row-major bf16 operands
// zero-padded to ld and hidden (multiples of 8), launched on s:
// h = GELU(in . w1 + b1) in bf16, in (m, ld), w1 (ld, hidden); z = h . w2 in
// f32, w2 (hidden, ld), bn2 output columns a block (64, 128, 192 or 256).
cudaError_t split_fc1(const __nv_bfloat16* in, const __nv_bfloat16* w1, const __nv_bfloat16* b1,
                      __nv_bfloat16* h, int m, int ld, int hidden, cudaStream_t s);
cudaError_t split_fc2_f32(const __nv_bfloat16* h, const __nv_bfloat16* w2, float* z, int m,
                          int ld, int hidden, int bn2, cudaStream_t s);

// y = LN(x) * g + b in x's dtype. PAD: ld > c, and the padded columns of y
// are zeroed.
template <typename T, bool PAD>
__global__ void __launch_bounds__(ROW_THREADS)
ln_rows(const T* __restrict__ x, const T* __restrict__ gam, const T* __restrict__ bet,
        T* __restrict__ y, int m, int c, int ld) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  if (r >= m) return;
  const T* xr = x + (size_t)r * ld;
  float mean, rstd;
  ROW_STATS(to_f32(xr[k]), c, mean, rstd);
  for (int k = lane; k < c; k += 32)
    y[(size_t)r * ld + k] =
        from_f32<T>((to_f32(xr[k]) - mean) * rstd * to_f32(gam[k]) + to_f32(bet[k]));
  if constexpr (PAD)
    for (int k = c + lane; k < ld; k += 32) y[(size_t)r * ld + k] = from_f32<T>(0.f);
}

// The forward's last pass: v = o2 + b2 in f32, post-norm its LN (f32
// statistics over the true c), rounded to x's dtype, then out = x + v in
// x's dtype -- the fused kernel's rounding points.
template <typename T, bool POST>
__global__ void __launch_bounds__(ROW_THREADS)
out_rows(const T* __restrict__ x, const float* __restrict__ o2, const T* __restrict__ b2,
         const T* __restrict__ gam, const T* __restrict__ bet, T* __restrict__ out, int m, int c,
         int ld) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  if (r >= m) return;
  const float* orow = o2 + (size_t)r * ld;
  const T* xr = x + (size_t)r * ld;
  float mean = 0.f, rstd = 1.f;
  if constexpr (POST) ROW_STATS(orow[k] + to_f32(b2[k]), c, mean, rstd);
  for (int k = lane; k < ld; k += 32) {
    float o = 0.f;
    if (k < c) {
      o = orow[k] + to_f32(b2[k]);
      if constexpr (POST) o = (o - mean) * rstd * to_f32(gam[k]) + to_f32(bet[k]);
      o = to_f32(xr[k]) + to_f32(from_f32<T>(o));
    }
    out[(size_t)r * ld + k] = from_f32<T>(o);
  }
}

}  // namespace ff
}  // namespace credit
