// Backward of the fused feed-forward with its residual, in the two forms of
// the TPU kernel:
//   pre-norm (CrossFormer):  out = x + fc2(GELU(fc1(LN(x))))
//   post-norm (SwinV2/FuXi): out = x + LN(fc2(GELU(fc1(x))))
// dx and the parameter gradients dg, db, dw1, db1, dw2, db2 summed over the
// rows in f32, recomputed from x and the cotangent ct.
//
// Replaces credit_tpu/ops/pallas_ff.py fused_ff_bwd (_ff_bwd_kernel at :214,
// the pallas_call at :400), both forms. In the port's training step every
// transformer FF's backward runs through it: 28 pre-norm calls per step at
// C = 128..1024, hidden H = 4C, M = 288000..4500 rows (the WXFormer), 16
// post-norm calls at C = 1024, M = 16905 (FuXi).
//
// Bound on the H100: operations. Pre-norm has five products of 2*M*C*H flops
// each (h1 = y.w1, da = ct.w2^T, dy = dh1.w1^T, dw1 = y^T.dh1, dw2 = a^T.ct),
// 10 M C H in all, against ~4 M C bytes of x, ct and dx: ~190 GFLOP per call
// at every WXFormer stage, 0.19 ms at the bf16 peak. Post-norm recomputes
// o2 = a.w2 as well: 12 M C H (and h1 twice here: 14 M C H are run).
//
// Design. The TPU kernel keeps the 4C-wide h1, GELU and dh1 in VMEM and sums
// the weight gradients across a grid that runs in order. On Hopper blocks
// run in parallel and a block cannot hold a C x 4C f32 gradient (256 KB at
// C = 128), so the work is a chain of passes on the caller's stream, and in
// bf16 every product runs on the warp-specialised TMA + wgmma mainloop of
// tma_gemm.cuh (the conv's and the forward's) with the operand majors it
// needs: the products with a transposed weight read it K-major (wgmma's B
// untransposed, w1 and w2 as they lie), the weight gradients contract over
// the rows with both operands MN-major. Pre-norm:
//   1. LN rows: y = LN(x) in x's dtype (ff_rows.cuh);
//   2. gelu_bwd_tc: h1 = y.w1 and da = ct.w2^T for one 128-row x 128-hidden
//      tile, two mainloop runs through one ring into two accumulator sets;
//      the epilogue writes a = GELU(h1 + b1) and dh1 = da GELU'(h1 + b1) in
//      x's dtype (by TMA stores) and, per row tile, the column sums of the
//      f32 dh1 (db1);
//   3. dy = dh1.w1^T (f32, M x C; prod_tc, B K-major);
//   4. the LN backward per row: dx = ct + rstd (dy g - mean(dy g) - xhat
//      mean(dy g xhat)), and per row block the column sums of dy xhat (dg),
//      dy (db) and ct (db2);
//   5. dw1 = y^T.dh1 and dw2 = a^T.ct (prod_tc, both operands MN-major),
//      split over the rows only where the output has too few tiles to fill
//      the card (cuda_ff.ffb_plan);
//   6. every partial summed in a fixed order, so the result is bitwise the
//      same from run to run.
// Post-norm (y = x, no input LN; the cotangent passes the output LN first):
//   1. a = GELU(x.w1 + b1) and o2 = a.w2 (f32) on the forward's split-route
//      products (fused_ff.cu: split_fc1, split_fc2_f32);
//   2. per row: o2 + b2, its LN statistics (two passes) and ohat; do2 = the
//      LN backward of ct g, in x's dtype, with per row block the column sums
//      of ct ohat (dg), ct (db) and the f32 do2 (db2);
//   3. pass 2 of pre-norm with y = x and do2 as the cotangent: dh1 and db1;
//   4. dx = ct + dh1.w1^T, the residual added in the product's epilogue;
//   5. dw1 = x^T.dh1 and dw2 = a^T.do2; 6. the sums.
// Unlike the TPU kernel it writes the M x 4C intermediates a and dh1, M x C
// of y or do2 and of f32 dy (pre-norm) or o2 (post-norm) to device memory
// and reads them back: PERF.md counts the bytes.
//
// Numerics are the TPU kernel's (pallas_ff.py:239-294): y, a, ct, do2 and dh1
// are in x's dtype where they enter a product; LN statistics, Phi, the pdf
// and every accumulator are f32; erf is the exact erff, where the TPU kernel
// used Abramowitz-Stegun 7.1.26 (1.5e-7 absolute). Any M is taken: TMA
// zero-fills past the rows and the stores are masked. Any C is taken: rows
// are zero-padded to ld, a multiple of 8 (the wrapper's copy: TMA's 16-byte
// strides), the statistics run over the true C, and the LN backward splits
// rows wider than 2048 into column slices over its grid. f32 runs the same
// passes with its products on FMA (64 x 64 tiles), and they also give the
// f32 forward at widths the fused kernel does not take
// (credit_fused_ff_passes, at the end).
#include <algorithm>

#include "ff_rows.cuh"
#include "tma_gemm.cuh"

namespace credit {
namespace ffb {

constexpr float kEps = 1e-5f;
constexpr float kSqrt1_2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;
constexpr int THREADS = 256;  // 8 warps everywhere
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float phi_of(float h) { return 0.5f * (1.f + erff(h * kSqrt1_2)); }

// ---------------------------------------------------------------- rows
// Every row kernel reads rows of `ld` elements (ld >= c, a multiple of 8 in
// bf16: the wrapper zero-pads a width that is not) and takes its statistics
// over the true width c; the columns in [c, ld) of what it writes are zero.

// The LN backward kernels keep per-warp column sums in shared memory for
// LN_CW columns (3 x 8 x 2048 f32 = 192 KB). WIDE (ld > c or ld > LN_CW):
// blockIdx.y picks a slice of LN_CW columns, every slice recomputes the
// rows' statistics, and the padded columns of the output are zeroed; the
// other form (the paths' widths) is the slice [0, c). Slices over the grid
// and the form as a template keep the paths' kernel at its 40 registers: a
// loop over slices inside the kernel took 63 and ran the stage-0 LN backward
// 22-62% slower on the H100. A lane reads 4 consecutive columns a step (16
// bytes of f32, 8 of bf16: rows are multiples of 8 wide and 16-byte
// aligned); the padding past c is zero in every input, so only the variance
// and the outputs mask it. A block owns `rows` rows (LN_ROWS, or fewer
// where there are few rows: cuda_ff.ffb_plan), one warp a row at a time.
constexpr int LN_ROWS = 64;
constexpr int LN_CW = 2048;

__host__ __device__ inline int ln_cols(int ld) { return ld < LN_CW ? ld : LN_CW; }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ void add4(float* p, float a, float b, float c, float d) {
  float4 v = *reinterpret_cast<float4*>(p);
  v.x += a, v.y += b, v.z += c, v.w += d;
  *reinterpret_cast<float4*>(p) = v;
}

// mean and rstd over the true width c of a row whose 4-column groups
// load(k) gives (zero past c), one warp a row: the mean, then the mean of
// squared deviations
template <class Load>
__device__ __forceinline__ void row_stats4(Load load, int c, int lane, float& mean, float& rstd) {
  const int cup = (c + 3) & ~3;
  float s = 0.f;
  for (int k = 4 * lane; k < cup; k += 128) {
    const float4 v = load(k);
    s += (v.x + v.y) + (v.z + v.w);
  }
  mean = warp_sum(s) / c;
  float q = 0.f;
  for (int k = 4 * lane; k < cup; k += 128) {
    const float4 v = load(k);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k + u < c) q += (e[u] - mean) * (e[u] - mean);
  }
  rstd = rsqrtf(warp_sum(q) / c + kEps);
}

// The per-warp sums [WARPS][3][cw] of columns [c0, c1) summed over the warps
// in order into part[block][j * ld + c0 + k], j = 0, 1, 2.
__device__ inline void store_col_sums(const float* cols, float* __restrict__ part, int cw, int c0,
                                      int c1, int ld) {
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * cw; i += THREADS) {
    const int j = i / cw, k = i % cw;
    if (c0 + k >= c1) continue;
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += cols[(size_t)w * 3 * cw + i];
    part[((size_t)blockIdx.x * 3 + j) * ld + c0 + k] = s;
  }
}

// LN backward, one warp a row: dx = ct + rstd (dxhat - mean(dxhat) - xhat
// mean(dxhat xhat)), dxhat = dy g. Column sums of dy xhat, dy and ct over
// the block's rows go to part[block][0..3 ld) (dg | db | db2), summed over
// the warps in order.
template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS)
ln_bwd_rows(const T* __restrict__ x, const T* __restrict__ ct, const float* __restrict__ dy,
            const T* __restrict__ gam, T* __restrict__ dx, float* __restrict__ part, int m,
            int c, int ld, int rows) {
  extern __shared__ __align__(16) float cols[];  // [WARPS][3][cw]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cw = WIDE ? ln_cols(ld) : c;
  const int c0 = WIDE ? blockIdx.y * LN_CW : 0, c1 = WIDE ? min(ld, c0 + cw) : c;
  const int cup = (c + 3) & ~3;
  float* mine = cols + (size_t)warp * 3 * cw;
  for (int k = lane; k < 3 * cw; k += 32) mine[k] = 0.f;
  const int r0 = blockIdx.x * rows;
  for (int r = r0 + warp; r < min(m, r0 + rows); r += WARPS) {
    const T* xr = x + (size_t)r * ld;
    const T* cr = ct + (size_t)r * ld;
    const float* dr = dy + (size_t)r * ld;
    float mean, rstd;
    row_stats4([&](int k) { return load4(xr + k); }, c, lane, mean, rstd);
    float s1 = 0.f, s2 = 0.f;
    for (int k = 4 * lane; k < cup; k += 128) {
      const float4 xv = load4(xr + k), dv = load4(dr + k), gv = load4(gam + k);
      const float xh[4] = {(xv.x - mean) * rstd, (xv.y - mean) * rstd, (xv.z - mean) * rstd,
                           (xv.w - mean) * rstd};
      const float d[4] = {dv.x, dv.y, dv.z, dv.w}, g[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s1 += d[u] * g[u];
        s2 += d[u] * g[u] * xh[u];
      }
      if (!WIDE || (k >= c0 && k < c1)) {
        const float4 cv = load4(cr + k);
        add4(mine + k - c0, d[0] * xh[0], d[1] * xh[1], d[2] * xh[2], d[3] * xh[3]);
        add4(mine + cw + k - c0, d[0], d[1], d[2], d[3]);
        add4(mine + 2 * cw + k - c0, cv.x, cv.y, cv.z, cv.w);
      }
    }
    const float m1 = warp_sum(s1) / c, m2 = warp_sum(s2) / c;
    for (int k = c0 + 4 * lane; k < c1; k += 128) {
      const float4 xv = load4(xr + k), dv = load4(dr + k), gv = load4(gam + k), cv = load4(cr + k);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w}, d[4] = {dv.x, dv.y, dv.z, dv.w};
      const float g[4] = {gv.x, gv.y, gv.z, gv.w}, cs[4] = {cv.x, cv.y, cv.z, cv.w};
      float o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float xhat = (xs[u] - mean) * rstd;
        o[u] = k + u < c ? cs[u] + rstd * (d[u] * g[u] - m1 - xhat * m2) : 0.f;
      }
      store4(dx + (size_t)r * ld + k, make_float4(o[0], o[1], o[2], o[3]));
    }
  }
  store_col_sums(cols, part, cw, c0, c1, ld);
}

// Post-norm LN backward, one warp a row: with o = o2 + b2, ohat = (o -
// mean) rstd and dohat = ct g, do2 = rstd (dohat - mean(dohat) - ohat
// mean(dohat ohat)) in x's dtype. Column sums of ct ohat, ct and the f32
// do2 over the block's rows go to part[block][0..3 ld) (dg | db | db2),
// summed over the warps in order.
template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS)
ln_post_bwd_rows(const float* __restrict__ o2, const T* __restrict__ b2, const T* __restrict__ ct,
                 const T* __restrict__ gam, T* __restrict__ do2, float* __restrict__ part, int m,
                 int c, int ld, int rows) {
  extern __shared__ __align__(16) float cols[];  // [WARPS][3][cw]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cw = WIDE ? ln_cols(ld) : c;
  const int c0 = WIDE ? blockIdx.y * LN_CW : 0, c1 = WIDE ? min(ld, c0 + cw) : c;
  const int cup = (c + 3) & ~3;
  float* mine = cols + (size_t)warp * 3 * cw;
  for (int k = lane; k < 3 * cw; k += 32) mine[k] = 0.f;
  const int r0 = blockIdx.x * rows;
  for (int r = r0 + warp; r < min(m, r0 + rows); r += WARPS) {
    const float* orow = o2 + (size_t)r * ld;
    const T* cr = ct + (size_t)r * ld;
    auto load_o = [&](int k) {
      const float4 ov = load4(orow + k), bv = load4(b2 + k);
      return make_float4(ov.x + bv.x, ov.y + bv.y, ov.z + bv.z, ov.w + bv.w);
    };
    float mean, rstd;
    row_stats4(load_o, c, lane, mean, rstd);
    float s1 = 0.f, s2 = 0.f;
    for (int k = 4 * lane; k < cup; k += 128) {
      const float4 ov = load_o(k), cv = load4(cr + k), gv = load4(gam + k);
      const float oh[4] = {(ov.x - mean) * rstd, (ov.y - mean) * rstd, (ov.z - mean) * rstd,
                           (ov.w - mean) * rstd};
      const float g[4] = {cv.x, cv.y, cv.z, cv.w}, gm[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s1 += g[u] * gm[u];
        s2 += g[u] * gm[u] * oh[u];
      }
      if (!WIDE || (k >= c0 && k < c1)) {
        add4(mine + k - c0, g[0] * oh[0], g[1] * oh[1], g[2] * oh[2], g[3] * oh[3]);
        add4(mine + cw + k - c0, g[0], g[1], g[2], g[3]);
      }
    }
    const float m1 = warp_sum(s1) / c, m2 = warp_sum(s2) / c;
    for (int k = c0 + 4 * lane; k < c1; k += 128) {
      const float4 ov = load_o(k), cv = load4(cr + k), gv = load4(gam + k);
      const float os[4] = {ov.x, ov.y, ov.z, ov.w}, g[4] = {cv.x, cv.y, cv.z, cv.w};
      const float gm[4] = {gv.x, gv.y, gv.z, gv.w};
      float d[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float ohat = (os[u] - mean) * rstd;
        d[u] = k + u < c ? rstd * (g[u] * gm[u] - m1 - ohat * m2) : 0.f;
      }
      add4(mine + 2 * cw + k - c0, d[0], d[1], d[2], d[3]);
      store4(do2 + (size_t)r * ld + k, make_float4(d[0], d[1], d[2], d[3]));
    }
  }
  store_col_sums(cols, part, cw, c0, c1, ld);
}

// dx = ct + dy in x's dtype (post-norm: the residual passes ct through)
template <typename T>
__global__ void add_rows(const T* __restrict__ ct, const float* __restrict__ dy,
                         T* __restrict__ dx, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dx[i] = from_f32<T>(to_f32(ct[i]) + dy[i]);
}

// out[i] = sum over k < nsum of part[k * n + i]: blockDim.x columns a
// block; its blockDim.y rows of threads each sum the parts k = ty, ty +
// rows, ... into four running sums in a fixed order, then the row sums are
// added in order, so the result is the same on every run. Few parts: 32
// columns x nsum rows; many: 8 x 128, so that a narrow sum (the db1
// partials of the WXFormer's stage 0: 512 columns of 2250 row tiles) still
// has loads in flight on many SMs.
constexpr int SUM_THREADS = 1024;

__global__ void __launch_bounds__(SUM_THREADS)
sum_parts(const float* __restrict__ part, float* __restrict__ out, size_t n, int nsum) {
  __shared__ float red[SUM_THREADS];
  const int cols = blockDim.x, rows = blockDim.y;
  const size_t i = blockIdx.x * (size_t)cols + threadIdx.x;
  float s[4] = {0.f, 0.f, 0.f, 0.f};  // four loads in flight
  if (i < n) {
    int k = threadIdx.y;
    for (; k + 3 * rows < nsum; k += 4 * rows)
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] += part[(size_t)(k + u * rows) * n + i];
    for (; k < nsum; k += rows) s[0] += part[(size_t)k * n + i];
  }
  red[threadIdx.y * cols + threadIdx.x] = (s[0] + s[1]) + (s[2] + s[3]);
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float t = 0.f;
    for (int r = 0; r < rows; ++r) t += red[r * cols + threadIdx.x];
    out[i] = t;
  }
}

// ---------------------------------------------------------------- bf16 products
// Every one a 128-row x BN tile of tma::gemm_tile / gemm_tile2 over K steps
// of 64; TMA zero-fills past every extent, so only the stores are masked.
// Row tiles of 128 also index the db1 partials.
constexpr int ROW_TILE = 128;

struct DualArgs {
  int m, hidden, steps;          // rows, hidden width, K steps over ld
  const __nv_bfloat16* b1;       // (hidden,)
  float* dbpart;                 // (row tiles, hidden): dh1's column sums
};

// Pass 2: h1 = in.w1 (t_in: in, 128-row boxes; t_w1: w1 MN-major) and da =
// g.w2^T (t_g: the cotangent of fc2's output; t_w2: w2 (hidden, ld) read
// K-major, BN-row boxes) for hidden columns [n0, n0 + BN) of a row tile;
// then a = GELU(h1 + b1) (WRITE_A), dh1 = da (Phi + h1 pdf) and the tile's
// column sums of the f32 dh1, summed over its 8 warps in order. a and dh1
// go through shared memory to TMA stores (t_a, t_dh: 64-column x 128-row
// boxes, clipped at the tensor's edge): thread-scattered 4-byte stores of
// them were the slowest part of the kernel at the WXFormer's stage 0. One
// block an SM (two accumulator sets of 128 x 128), persistent over the
// tiles (the hidden tile fastest), so that the next tile's loads run beside
// this one's epilogue. (On the H100, 128 x 64 tiles at two blocks an SM,
// or a block a tile, read slower at every path shape.)
constexpr int DUAL_BN = 128;

struct DualSmem {
  static constexpr int TILE = 128 * 128;                  // a 64-column x 128-row bf16 box
  static constexpr int OUT = 2 * (DUAL_BN / 64) * TILE;    // a, then dh1, swizzled
  static constexpr int EXTRA = 1024 + OUT + 8 * DUAL_BN * 4;  // + alignment; + sums [8 warps][BN]
};

using DualRing = tma::Ring<DUAL_BN, 1, DualSmem::EXTRA>;

// byte offset of (row, col) in a 128-row output tile of DUAL_BN columns
// stored as 64-column boxes of 128-byte rows with 128-byte swizzle (TMA's
// layout)
__device__ __forceinline__ int out_offset(int row, int col) {
  return (col / 64) * DualSmem::TILE + row * 128 + ((((col % 64) / 8) ^ (row % 8)) << 4) +
         (col % 8) * 2;
}

template <bool WRITE_A>
__global__ void __launch_bounds__(DualRing::THREADS, 1)
gelu_bwd_tc(const __grid_constant__ CUtensorMap t_in, const __grid_constant__ CUtensorMap t_w1,
            const __grid_constant__ CUtensorMap t_g, const __grid_constant__ CUtensorMap t_w2,
            const __grid_constant__ CUtensorMap t_a, const __grid_constant__ CUtensorMap t_dh,
            const DualArgs g) {
  constexpr int BN = DUAL_BN;
  using R = DualRing;
  using S = DualSmem;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int ntn = (g.hidden + BN - 1) / BN;
  const int tiles = ntn * ((g.m + ROW_TILE - 1) / ROW_TILE);
  unsigned char* out = align1024(R::extra(align1024(smem_raw)));  // a | dh1 tiles
  float* red = reinterpret_cast<float*>(out + S::OUT);
  constexpr int first = 128;  // the first consumer thread issues the stores
  tma::gemm_tiles2<R, BN, 1, 1, 0>(
      smem_raw, tiles, g.steps, g.steps,
      [&](int t, int it, unsigned char* st, uint64_t* bar) {
        const int n0 = t % ntn * BN, m0 = t / ntn * ROW_TILE;
        if (it < g.steps) {
          tma_load_2d(st, &t_in, bar, it * tma::KS, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(st + tma::A_BYTES + j * tma::BOX_BYTES, &t_w1, bar, n0 + 64 * j,
                        it * tma::KS);
        } else {
          const int k = (it - g.steps) * tma::KS;
          tma_load_2d(st, &t_g, bar, k, m0);
          tma_load_2d(st + tma::A_BYTES, &t_w2, bar, k, n0);
        }
      },
      [&](int t, float (&h)[BN / 2], float (&d)[BN / 2], int cw) {
        const int n0 = t % ntn * BN, mt = t / ntn, m0 = mt * ROW_TILE;
        const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
        const int c = threadIdx.x - first;  // 0..255 over the consumers
        if (c == 0) bulk_wait_read();  // the previous tile's stores have read the tiles
        named_sync(1, 256);            // ... and its sums are read
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int cl = 8 * j + 2 * (lane % 4), col = n0 + cl;  // hidden % 8 == 0: col + 1 too
          float2 bb = make_float2(0.f, 0.f);
          if (col < g.hidden)
            bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.b1 + col));
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int rl = cw * 64 + warp * 16 + lane / 4 + 8 * r;
            const float h0 = h[4 * j + 2 * r] + bb.x, h1 = h[4 * j + 2 * r + 1] + bb.y;
            const float p0 = phi_of(h0), p1 = phi_of(h1);
            if constexpr (WRITE_A)
              *reinterpret_cast<uint32_t*>(out + out_offset(rl, cl)) = pack_bf16(h0 * p0, h1 * p1);
            const float d0 = d[4 * j + 2 * r] * (p0 + h0 * expf(-0.5f * h0 * h0) * kInvSqrt2Pi);
            const float d1 = d[4 * j + 2 * r + 1] * (p1 + h1 * expf(-0.5f * h1 * h1) * kInvSqrt2Pi);
            *reinterpret_cast<uint32_t*>(out + S::OUT / 2 + out_offset(rl, cl)) = pack_bf16(d0, d1);
            if (m0 + rl < g.m) {  // rows past m hold da = 0 (zero-filled ct): masked all the same
              s0 += d0;
              s1 += d1;
            }
          }
          // the warp's 16 rows: lanes of one lane % 4 hold one column pair
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, o);
            s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          }
          if (lane < 4) {
            red[(cw * 4 + warp) * BN + 8 * j + 2 * lane] = s0;
            red[(cw * 4 + warp) * BN + 8 * j + 2 * lane + 1] = s1;
          }
        }
        fence_proxy_async();  // the tiles' generic writes, before the TMA stores read them
        named_sync(1, 256);
        if (c == 0) {
#pragma unroll
          for (int q = 0; q < BN / 64; ++q) {
            if constexpr (WRITE_A) tma_store_2d(&t_a, out + q * S::TILE, n0 + 64 * q, m0);
            tma_store_2d(&t_dh, out + S::OUT / 2 + q * S::TILE, n0 + 64 * q, m0);
          }
          bulk_commit();
        }
        for (int col = c; col < BN; col += 256) {
          if (n0 + col >= g.hidden) continue;
          float sum = 0.f;
          for (int w = 0; w < 8; ++w) sum += red[w * BN + col];
          g.dbpart[(size_t)mt * g.hidden + n0 + col] = sum;
        }
      });
  if (threadIdx.x == first) bulk_wait_all();  // shared memory outlives the stores
}

struct ProdArgs {
  int m, n;                    // output rows and columns (n % 8 == 0)
  int steps, per;              // K steps in all and per split (blockIdx.z)
  float* out;                  // f32: split z's (m, n) at out + z m n
  const __nv_bfloat16* res;    // RES: out16 = bf16(res + acc), both (m, n)
  __nv_bfloat16* out16;
};

// Passes 3 and 5: out[z] = A . B over split z's K steps. TA = 0: A (m rows x
// K) row-major, 128-row boxes; TA = 1: A stored (K x m), two 64 x 64 boxes
// (the weight gradients: the rows of y or a are the contraction). TB = 0: B
// stored (n x K), BN-row boxes (w1 read as w1^T); TB = 1: B (K x n), 64 x 64
// boxes. RES (post-norm dy, one split): dx = ct + dy written in bf16, so the
// f32 dy never reaches device memory.
template <int BN, int CTAS, int TA, int TB, bool RES = false>
__global__ void __launch_bounds__(tma::Ring<BN, CTAS>::THREADS, CTAS)
prod_tc(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
        const ProdArgs g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * ROW_TILE;
  const int it0 = blockIdx.z * g.per;
  tma::gemm_tile<BN, CTAS, TA, TB>(
      smem_raw, max(0, min(g.steps - it0, g.per)),
      [&](int it, unsigned char* st, uint64_t* bar) {
        const int k = (it0 + it) * tma::KS;
        if constexpr (TA == 1) {
          tma_load_2d(st, &ta, bar, m0, k);
          tma_load_2d(st + tma::BOX_BYTES, &ta, bar, m0 + 64, k);
        } else {
          tma_load_2d(st, &ta, bar, k, m0);
        }
        if constexpr (TB == 1) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(st + tma::A_BYTES + j * tma::BOX_BYTES, &tb, bar, n0 + 64 * j, k);
        } else {
          tma_load_2d(st + tma::A_BYTES, &tb, bar, k, n0);
        }
      },
      [&](float (&acc)[BN / 2], int cw) {
        const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
        float* o = g.out + (size_t)blockIdx.z * g.m * g.n;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + cw * 64 + warp * 16 + lane / 4 + 8 * r;
          if (row >= g.m) continue;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * (lane % 4);
            if (col >= g.n) continue;
            const size_t at = (size_t)row * g.n + col;
            const float a0 = acc[4 * j + 2 * r], a1 = acc[4 * j + 2 * r + 1];
            if constexpr (RES) {
              const __nv_bfloat162 c2 = *reinterpret_cast<const __nv_bfloat162*>(g.res + at);
              *reinterpret_cast<uint32_t*>(g.out16 + at) =
                  pack_bf16(__low2float(c2) + a0, __high2float(c2) + a1);
            } else {
              *reinterpret_cast<float2*>(o + at) = make_float2(a0, a1);
            }
          }
        }
      });
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <bool WRITE_A>
cudaError_t launch_gelu_bwd(const CUtensorMap* t, const DualArgs& g, cudaStream_t s) {
  using R = DualRing;
  cudaFuncSetAttribute(gelu_bwd_tc<WRITE_A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)R::SMEM);
  const int tiles = (g.hidden + DUAL_BN - 1) / DUAL_BN * ((g.m + ROW_TILE - 1) / ROW_TILE);
  gelu_bwd_tc<WRITE_A><<<std::min(tiles, sm_count()), R::THREADS, R::SMEM, s>>>(
      t[0], t[1], t[2], t[3], t[4], t[5], g);
  return cudaGetLastError();
}

template <int BN, int CTAS, int TA, int TB, bool RES = false>
cudaError_t launch_prod(const CUtensorMap& ta, const CUtensorMap& tb, const ProdArgs& g,
                        int splits, cudaStream_t s) {
  using R = tma::Ring<BN, CTAS>;
  cudaFuncSetAttribute(prod_tc<BN, CTAS, TA, TB, RES>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)R::SMEM);
  const dim3 grid((g.n + BN - 1) / BN, (g.m + ROW_TILE - 1) / ROW_TILE, splits);
  prod_tc<BN, CTAS, TA, TB, RES><<<grid, R::THREADS, R::SMEM, s>>>(ta, tb, g);
  return cudaGetLastError();
}

// dy = dh1 . w1^T (RES: dx = ct + dy): BN 64 and 128 run two blocks an SM
// (one block's stores beside the other's products), 192 and 256 one
template <bool RES>
cudaError_t launch_dy(int bn, const CUtensorMap& ta, const CUtensorMap& tb, const ProdArgs& g,
                      cudaStream_t s) {
  switch (bn) {
    case 64: return launch_prod<64, 2, 0, 0, RES>(ta, tb, g, 1, s);
    case 128: return launch_prod<128, 2, 0, 0, RES>(ta, tb, g, 1, s);
    case 192: return launch_prod<192, 1, 0, 0, RES>(ta, tb, g, 1, s);
    case 256: return launch_prod<256, 1, 0, 0, RES>(ta, tb, g, 1, s);
    default: return cudaErrorInvalidValue;
  }
}

// a weight gradient over `splits` row splits, one block an SM
cudaError_t launch_dw(int bn, const CUtensorMap& ta, const CUtensorMap& tb, const ProdArgs& g,
                      int splits, cudaStream_t s) {
  switch (bn) {
    case 64: return launch_prod<64, 1, 1, 1>(ta, tb, g, splits, s);
    case 128: return launch_prod<128, 1, 1, 1>(ta, tb, g, splits, s);
    case 192: return launch_prod<192, 1, 1, 1>(ta, tb, g, splits, s);
    case 256: return launch_prod<256, 1, 1, 1>(ta, tb, g, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- f32 products
// 64 x 64 tiles, thread (tm, tn) of 16 x 16 owns a 4 x 4 block, FMA.
constexpr int F_B = 64, F_K = 16, F_LD = F_B + 4;

template <bool AT, bool BT>
__device__ void fma_loop(float (&acc)[4][4], const float* __restrict__ A, int lda,
                         const float* __restrict__ B, int ldb, int M, int N, int m0, int n0,
                         int k0, int k1, float* sa, float* sb) {
  const int tn = threadIdx.x % 16, tm = threadIdx.x / 16;
  for (int kb = k0; kb < k1; kb += F_K) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_K * F_B; i += THREADS) {
      // sa[k][m], sb[k][n]; the read follows the stored row for coalescing
      int k, mm;
      if (AT) k = i / F_B, mm = i % F_B;
      else k = i % F_K, mm = i / F_K;
      const int gk = kb + k, gm = m0 + mm;
      sa[k * F_LD + mm] =
          (gk < k1 && gm < M) ? (AT ? A[(size_t)gk * lda + gm] : A[(size_t)gm * lda + gk]) : 0.f;
      int kn, nn;
      if (BT) kn = i % F_K, nn = i / F_K;
      else kn = i / F_B, nn = i % F_B;
      const int gk2 = kb + kn, gn = n0 + nn;
      sb[kn * F_LD + nn] =
          (gk2 < k1 && gn < N) ? (BT ? B[(size_t)gn * ldb + gk2] : B[(size_t)gk2 * ldb + gn])
                               : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_K; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(sa + k * F_LD + tm * 4);
      const float4 bv = *reinterpret_cast<const float4*>(sb + k * F_LD + tn * 4);
      const float a[4] = {av.x, av.y, av.z, av.w}, b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();
}

template <bool GRAD>
__global__ void __launch_bounds__(THREADS)
gelu_bwd_f32(const float* __restrict__ y, const float* __restrict__ ct,
             const float* __restrict__ w1, const float* __restrict__ b1,
             const float* __restrict__ w2, float* __restrict__ a_out, float* __restrict__ dh_out,
             float* __restrict__ dbpart, int m, int c, int hidden) {
  __shared__ __align__(16) float sa[F_K * F_LD], sb[F_K * F_LD];
  __shared__ float red[16][F_B];
  const int tn = threadIdx.x % 16, tm = threadIdx.x / 16;
  const int m0 = blockIdx.y * F_B, n0 = blockIdx.x * F_B;
  float h[4][4] = {}, d[4][4] = {};
  fma_loop<false, false>(h, y, c, w1, hidden, m, hidden, m0, n0, 0, c, sa, sb);
  if constexpr (GRAD) fma_loop<false, true>(d, ct, c, w2, c, m, hidden, m0, n0, 0, c, sa, sb);
  float colsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + tm * 4 + i, col = n0 + tn * 4 + j;
      if (r >= m || col >= hidden) continue;
      const float h1 = h[i][j] + b1[col];
      const float p = phi_of(h1);
      if (a_out != nullptr) a_out[(size_t)r * hidden + col] = h1 * p;
      if constexpr (GRAD) {
        const float dh = d[i][j] * (p + h1 * expf(-0.5f * h1 * h1) * kInvSqrt2Pi);
        dh_out[(size_t)r * hidden + col] = dh;
        colsum[j] += dh;
      }
    }
  if constexpr (!GRAD) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) red[tm][tn * 4 + j] = colsum[j];
  __syncthreads();
  for (int col = threadIdx.x; col < F_B; col += THREADS) {
    if (n0 + col >= hidden) continue;
    float s = 0.f;
    for (int g = 0; g < 16; ++g) s += red[g][col];
    dbpart[(size_t)blockIdx.y * hidden + n0 + col] = s;
  }
}

template <bool AT, bool BT>
__global__ void __launch_bounds__(THREADS)
gemm_f32(const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
         float* __restrict__ out, int M, int N, int K, int kper) {
  __shared__ __align__(16) float sa[F_K * F_LD], sb[F_K * F_LD];
  const int tn = threadIdx.x % 16, tm = threadIdx.x / 16;
  const int m0 = blockIdx.y * F_B, n0 = blockIdx.x * F_B;
  const int k0 = blockIdx.z * kper, k1 = min(K, k0 + kper);
  float acc[4][4] = {};
  fma_loop<AT, BT>(acc, A, lda, B, ldb, M, N, m0, n0, k0, k1, sa, sb);
  float* o = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + tm * 4 + i, col = n0 + tn * 4 + j;
      if (r < M && col < N) o[(size_t)r * N + col] = acc[i][j];
    }
}

// ---------------------------------------------------------------- f32
inline size_t al(size_t v) { return align_up(v, 256); }

// The f32 passes' workspace and splits. Every offset and extent below is in
// the padded width ld (see the rows).
struct Plan {
  int row_tiles, ln_blocks;
  int s1, s2;    // splits of dw1 (C x H) and dw2 (H x C) over the rows
  size_t y, a, dh, dy, p1, p2, pdb, pln, total;  // workspace offsets, bytes
};

inline int splits_for(int rows, int cols, int m) {
  const int tiles = ((rows + F_B - 1) / F_B) * ((cols + F_B - 1) / F_B);
  const int s = (2 * 132 + tiles - 1) / tiles;
  return std::max(1, std::min(s, m / 512));
}

inline Plan plan(int m, int ld, int hidden) {
  Plan p{};
  p.row_tiles = (m + F_B - 1) / F_B;
  p.ln_blocks = (m + LN_ROWS - 1) / LN_ROWS;
  p.s1 = splits_for(ld, hidden, m);
  p.s2 = splits_for(hidden, ld, m);
  size_t o = 0;
  p.y = o, o += al((size_t)m * ld * 4);
  p.a = o, o += al((size_t)m * hidden * 4);
  p.dh = o, o += al((size_t)m * hidden * 4);
  p.dy = o, o += al((size_t)m * ld * 4);
  p.p1 = o, o += p.s1 > 1 ? al((size_t)p.s1 * ld * hidden * 4) : 0;
  p.p2 = o, o += p.s2 > 1 ? al((size_t)p.s2 * hidden * ld * 4) : 0;
  p.pdb = o, o += al((size_t)p.row_tiles * hidden * 4);
  p.pln = o, o += al((size_t)p.ln_blocks * 3 * ld * 4);
  p.total = o;
  return p;
}

inline void sum_into(const float* part, float* out, size_t n, int nsum, cudaStream_t s) {
  const int cols = nsum <= 32 ? 32 : 8, rows = std::min(nsum, SUM_THREADS / cols);
  sum_parts<<<(unsigned)((n + cols - 1) / cols), dim3(cols, rows), 0, s>>>(part, out, n, nsum);
}

inline int kper_for(int k, int splits, int bk) {
  const int per = (k + splits - 1) / splits;
  return (per + bk - 1) / bk * bk;
}

inline size_t ln_smem(int ld) { return (size_t)WARPS * 3 * ln_cols(ld) * 4; }

// The LN backward's last row pass: pre-norm dx and the dg / db / db2
// partials; post-norm (before the products) do2 and its partials
template <typename T>
void ln_bwd(const T* x, const T* ct, const float* dy, const T* gam, T* dx, float* pln, int m,
            int c, int ld, int rows, cudaStream_t s) {
  auto kern = ld > c || ld > LN_CW ? ln_bwd_rows<T, true> : ln_bwd_rows<T, false>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ln_smem(ld));
  kern<<<dim3((m + rows - 1) / rows, (ld + LN_CW - 1) / LN_CW), THREADS, ln_smem(ld), s>>>(
      x, ct, dy, gam, dx, pln, m, c, ld, rows);
}

template <typename T>
void ln_post_bwd(const float* o2, const T* b2, const T* ct, const T* gam, T* do2, float* pln,
                 int m, int c, int ld, int rows, cudaStream_t s) {
  auto kern = ld > c || ld > LN_CW ? ln_post_bwd_rows<T, true> : ln_post_bwd_rows<T, false>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ln_smem(ld));
  kern<<<dim3((m + rows - 1) / rows, (ld + LN_CW - 1) / LN_CW), THREADS, ln_smem(ld), s>>>(
      o2, b2, ct, gam, do2, pln, m, c, ld, rows);
}

template <typename T>
void add_into(const T* ct, const float* dy, T* dx, size_t n, cudaStream_t s) {
  add_rows<T><<<(int)std::min<size_t>((n + 255) / 256, 4096), 256, 0, s>>>(ct, dy, dx, n);
}

void run_f32(const float* x, const float* ct, const float* gam, const float* bet,
             const float* w1, const float* b1, const float* w2, const float* b2, float* dx,
             float* dln, float* dw1, float* db1, float* dw2, unsigned char* work, int m, int c,
             int ld, int hidden, bool post, cudaStream_t s) {
  const Plan p = plan(m, ld, hidden);
  // pre-norm: y = LN(x); post-norm: the slot holds do2 and fc1 reads x
  float* y = reinterpret_cast<float*>(work + p.y);
  float* a = reinterpret_cast<float*>(work + p.a);
  float* dh = reinterpret_cast<float*>(work + p.dh);
  // post-norm: o2 first, dy once o2 is consumed
  float* dy = reinterpret_cast<float*>(work + p.dy);
  float* p1 = p.s1 > 1 ? reinterpret_cast<float*>(work + p.p1) : dw1;
  float* p2 = p.s2 > 1 ? reinterpret_cast<float*>(work + p.p2) : dw2;
  float* pdb = reinterpret_cast<float*>(work + p.pdb);
  float* pln = reinterpret_cast<float*>(work + p.pln);
  const float* fc1_in = post ? x : y;
  const float* grad_out = post ? y : ct;  // the cotangent of fc2's output
  const dim3 g2((hidden + F_B - 1) / F_B, p.row_tiles);
  const dim3 g3((ld + F_B - 1) / F_B, (m + F_B - 1) / F_B, 1);
  const int kp1 = kper_for(m, p.s1, F_K), kp2 = kper_for(m, p.s2, F_K);
  const dim3 g5a((hidden + F_B - 1) / F_B, (ld + F_B - 1) / F_B, p.s1);
  const dim3 g5b((ld + F_B - 1) / F_B, (hidden + F_B - 1) / F_B, p.s2);
  if (post) {
    // 1. a = GELU(x.w1 + b1); 2. o2 = a.w2; 3. do2 and the dg / db / db2 partials
    gelu_bwd_f32<false><<<g2, THREADS, 0, s>>>(x, ct, w1, b1, w2, a, nullptr, nullptr, m, ld,
                                               hidden);
    gemm_f32<false, false><<<g3, THREADS, 0, s>>>(a, hidden, w2, ld, dy, m, ld, hidden, hidden);
    ln_post_bwd<float>(dy, b2, ct, gam, y, pln, m, c, ld, LN_ROWS, s);
  } else {
    // 1. y = LN(x)
    (ld > c ? ff::ln_rows<float, true> : ff::ln_rows<float, false>)<<<(m + WARPS - 1) / WARPS,
                                                                     THREADS, 0, s>>>(
        x, gam, bet, y, m, c, ld);
  }
  // 2. dh1 and the db1 partials (a as well, pre-norm); 3. dy = dh1 . w1^T;
  // 5. dw1 = y^T . dh1 (C x H), dw2 = a^T . grad_out (H x C), split over rows
  gelu_bwd_f32<true><<<g2, THREADS, 0, s>>>(fc1_in, grad_out, w1, b1, w2, post ? nullptr : a, dh,
                                            pdb, m, ld, hidden);
  gemm_f32<false, true><<<g3, THREADS, 0, s>>>(dh, hidden, w1, hidden, dy, m, ld, hidden, hidden);
  gemm_f32<true, false><<<g5a, THREADS, 0, s>>>(fc1_in, ld, dh, hidden, p1, ld, hidden, m, kp1);
  gemm_f32<true, false><<<g5b, THREADS, 0, s>>>(a, hidden, grad_out, ld, p2, hidden, ld, m, kp2);
  // 4. dx (post-norm: ct + dy), and pre-norm the dg / db / db2 partials
  if (post)
    add_into<float>(ct, dy, dx, (size_t)m * ld, s);
  else
    ln_bwd<float>(x, ct, dy, gam, dx, pln, m, c, ld, LN_ROWS, s);
  // the partials, in a fixed order
  if (p.s1 > 1) sum_into(p1, dw1, (size_t)ld * hidden, p.s1, s);
  if (p.s2 > 1) sum_into(p2, dw2, (size_t)hidden * ld, p.s2, s);
  sum_into(pdb, db1, hidden, p.row_tiles, s);
  sum_into(pln, dln, (size_t)3 * ld, p.ln_blocks, s);
}

// ---------------------------------------------------------------- bf16
// The bf16 passes on wgmma. The plan (cuda_ff.ffb_plan) picks every
// product's BN and the weight gradients' row splits; the caller provides
// each buffer.
struct Bf16Plan {
  int ln_rows;         // rows a block of the LN backward
  int bn_o2;           // post-norm o2 = a.w2 (64, 128, 192 or 256)
  int bn_dy;           // dy = dh1.w1^T (64, 128, 192 or 256)
  int bn_w1, s1;       // dw1 (ld x hidden): BN and row splits
  int bn_w2, s2;       // dw2 (hidden x ld)
};

struct Bf16Work {
  __nv_bfloat16 *y, *a, *dh;  // y (m, ld: post-norm do2), a and dh1 (m, hidden)
  float *dy, *p1, *p2;        // dy (m, ld: post-norm o2 first); dw1 / dw2 split partials
  float *pdb, *pln;           // db1 partials (row tiles, hidden); LN partials (blocks, 3, ld)
};

cudaError_t run_bf16(const __nv_bfloat16* x, const __nv_bfloat16* ct, const __nv_bfloat16* gam,
                     const __nv_bfloat16* bet, const __nv_bfloat16* w1, const __nv_bfloat16* b1,
                     const __nv_bfloat16* w2, const __nv_bfloat16* b2, __nv_bfloat16* dx,
                     float* dln, float* dw1, float* db1, float* dw2, const Bf16Work& w,
                     const Bf16Plan& p, int m, int c, int ld, int hidden, bool post,
                     cudaStream_t s) {
  using B = __nv_bfloat16;
  using tma::operand_map;
  cudaError_t err;
  const B* fc1_in = post ? x : w.y;
  const B* grad_out = post ? w.y : ct;  // the cotangent of fc2's output
  if (post) {
    // 1. a = GELU(x.w1 + b1), o2 = a.w2; 2. do2 and the dg / db / db2 partials
    if ((err = ff::split_fc1(x, w1, b1, w.a, m, ld, hidden, s)) != cudaSuccess) return err;
    if ((err = ff::split_fc2_f32(w.a, w2, w.dy, m, ld, hidden, p.bn_o2, s)) != cudaSuccess)
      return err;
    ln_post_bwd<B>(w.dy, b2, ct, gam, w.y, w.pln, m, c, ld, p.ln_rows, s);
  } else {
    // 1. y = LN(x)
    (ld > c ? ff::ln_rows<B, true> : ff::ln_rows<B, false>)<<<(m + WARPS - 1) / WARPS, THREADS,
                                                             0, s>>>(x, gam, bet, w.y, m, c, ld);
  }
  // 2. dh1 and the db1 partials (a as well, pre-norm)
  CUtensorMap t2[6], ta, tb;  // in, w1, g, w2; the stores of a and dh1
  if (!operand_map(&t2[0], fc1_in, m, ld, ROW_TILE) || !operand_map(&t2[1], w1, ld, hidden, 64) ||
      !operand_map(&t2[2], grad_out, m, ld, ROW_TILE) ||
      !operand_map(&t2[3], w2, hidden, ld, DUAL_BN) ||
      !operand_map(&t2[4], w.a, m, hidden, ROW_TILE) ||
      !operand_map(&t2[5], w.dh, m, hidden, ROW_TILE))
    return cudaErrorInvalidValue;
  const DualArgs dual{m, hidden, (ld + tma::KS - 1) / tma::KS, b1, w.pdb};
  err = post ? launch_gelu_bwd<false>(t2, dual, s) : launch_gelu_bwd<true>(t2, dual, s);
  if (err != cudaSuccess) return err;
  // 3. dy = dh1 . w1^T (w1 read K-major)
  if (!operand_map(&ta, w.dh, m, hidden, ROW_TILE) || !operand_map(&tb, w1, ld, hidden, p.bn_dy))
    return cudaErrorInvalidValue;
  // (post-norm: dx = ct + dy, step 5, in the product's epilogue)
  const int hsteps = (hidden + tma::KS - 1) / tma::KS, msteps = (m + tma::KS - 1) / tma::KS;
  const ProdArgs pdy{m, ld, hsteps, hsteps, w.dy, ct, dx};
  if ((err = post ? launch_dy<true>(p.bn_dy, ta, tb, pdy, s) : launch_dy<false>(p.bn_dy, ta, tb, pdy, s)) !=
      cudaSuccess)
    return err;
  // 5. dw1 = y^T . dh1 (ld x hidden), dw2 = a^T . grad_out (hidden x ld)
  float* p1 = p.s1 > 1 ? w.p1 : dw1;
  float* p2 = p.s2 > 1 ? w.p2 : dw2;
  if (!operand_map(&ta, fc1_in, m, ld, 64) || !operand_map(&tb, w.dh, m, hidden, 64))
    return cudaErrorInvalidValue;
  const int per1 = (msteps + p.s1 - 1) / p.s1, per2 = (msteps + p.s2 - 1) / p.s2;
  if ((err = launch_dw(p.bn_w1, ta, tb, ProdArgs{ld, hidden, msteps, per1, p1, nullptr, nullptr},
                       p.s1, s)) !=
      cudaSuccess)
    return err;
  if (!operand_map(&ta, w.a, m, hidden, 64) || !operand_map(&tb, grad_out, m, ld, 64))
    return cudaErrorInvalidValue;
  if ((err = launch_dw(p.bn_w2, ta, tb, ProdArgs{hidden, ld, msteps, per2, p2, nullptr, nullptr},
                       p.s2, s)) !=
      cudaSuccess)
    return err;
  // 4. pre-norm: dx and the dg / db / db2 partials
  if (!post) ln_bwd<B>(x, ct, w.dy, gam, dx, w.pln, m, c, ld, p.ln_rows, s);
  // the partials, in a fixed order
  if (p.s1 > 1) sum_into(p1, dw1, (size_t)ld * hidden, p.s1, s);
  if (p.s2 > 1) sum_into(p2, dw2, (size_t)hidden * ld, p.s2, s);
  sum_into(w.pdb, db1, hidden, (m + ROW_TILE - 1) / ROW_TILE, s);
  sum_into(w.pln, dln, (size_t)3 * ld, (m + p.ln_rows - 1) / p.ln_rows, s);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- forward in passes
// The f32 forward at widths the fused kernel (fused_ff.cu) does not take --
// C > 1024, or C % 8 != 0 (padded to ld) -- as the backward's passes:
// pre-norm y = LN(x); a = GELU(fc1_in . w1 + b1); o2 = a . w2; then
// out = x + (o2 + b2) or x + LN(o2 + b2). (bf16 takes fused_ff.cu's split
// route at those widths.) Workspace: y (pre-norm), a and o2.
struct FwdPlan {
  size_t y, a, o2, total;
};

inline FwdPlan fwd_plan(int m, int ld, int hidden) {
  FwdPlan p{};
  size_t o = 0;
  p.y = o, o += al((size_t)m * ld * 4);
  p.a = o, o += al((size_t)m * hidden * 4);
  p.o2 = o, o += al((size_t)m * ld * 4);
  p.total = o;
  return p;
}

void run_fwd(const float* x, const float* gam, const float* bet, const float* w1,
             const float* b1, const float* w2, const float* b2, float* out,
             unsigned char* work, int m, int c, int ld, int hidden, bool post, cudaStream_t s) {
  const FwdPlan p = fwd_plan(m, ld, hidden);
  float* y = reinterpret_cast<float*>(work + p.y);
  float* a = reinterpret_cast<float*>(work + p.a);
  float* o2 = reinterpret_cast<float*>(work + p.o2);
  const float* fc1_in = post ? x : y;
  const int blocks = (m + WARPS - 1) / WARPS;
  if (!post)
    (ld > c ? ff::ln_rows<float, true> : ff::ln_rows<float, false>)<<<blocks, THREADS, 0, s>>>(
        x, gam, bet, y, m, c, ld);
  const dim3 g2((hidden + F_B - 1) / F_B, (m + F_B - 1) / F_B);
  gelu_bwd_f32<false><<<g2, THREADS, 0, s>>>(fc1_in, nullptr, w1, b1, nullptr, a, nullptr,
                                             nullptr, m, ld, hidden);
  const dim3 g3((ld + F_B - 1) / F_B, (m + F_B - 1) / F_B, 1);
  gemm_f32<false, false><<<g3, THREADS, 0, s>>>(a, hidden, w2, ld, o2, m, ld, hidden, hidden);
  if (post)
    ff::out_rows<float, true><<<blocks, THREADS, 0, s>>>(x, o2, b2, gam, bet, out, m, c, ld);
  else
    ff::out_rows<float, false><<<blocks, THREADS, 0, s>>>(x, o2, b2, gam, bet, out, m, c, ld);
}

}  // namespace ffb
}  // namespace credit

using namespace credit;

// Bytes of workspace `credit_fused_ff_bwd_f32` needs for (m, ld, hidden).
extern "C" long long credit_fused_ff_bwd_workspace(int m, int ld, int hidden) {
  return (long long)ffb::plan(m, ld, hidden).total;
}

// The operands of both entries: x, ct, dx (m, ld); gam, bet, b2 (ld,); w1
// (ld, hidden); b1 (hidden,); w2 (hidden, ld), all of one dtype, contiguous,
// 16-byte aligned; ld and hidden multiples of 8, ld >= c, the true width:
// columns past c and the parameters' rows / columns there are zero, and stay
// out of every statistic (b2 shifts no statistic in pre-norm form, which
// does not read it). post_norm: 0 for the backward of x + fc2(GELU(fc1(LN(x)))),
// 1 for x + LN(fc2(GELU(fc1(x)))). Outputs f32: dln (3, ld) = dg | db | db2,
// dw1 (ld, hidden), db1 (hidden,), dw2 (hidden, ld); zero past c.

// f32, products on FMA. work: credit_fused_ff_bwd_workspace bytes.
extern "C" int credit_fused_ff_bwd_f32(const void* x, const void* ct, const void* gam,
                                       const void* bet, const void* w1, const void* b1,
                                       const void* w2, const void* b2, void* dx, void* dln,
                                       void* dw1, void* db1, void* dw2, void* work, int m, int c,
                                       int ld, int hidden, int post_norm, void* stream) {
  if (m < 1 || c < 1 || ld < c || ld % 8 || hidden < 8 || hidden % 8)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  ffb::run_f32(f(x), f(ct), f(gam), f(bet), f(w1), f(b1), f(w2), f(b2), o(dx), o(dln), o(dw1),
               o(db1), o(dw2), static_cast<unsigned char*>(work), m, c, ld, hidden,
               post_norm != 0, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// bf16, products on wgmma (see above), on the plan of cuda_ff.ffb_plan:
// ln_rows rows a block of the LN backward, bn_o2 / bn_dy /
// bn_w1 / bn_w2 in 64, 128, 192, 256, s1 / s2 >= 1 row splits of dw1 / dw2.
// Buffers from the caller: y (m, ld) bf16, a and dh (m, hidden) bf16, dy
// (m, ld) f32, p1 (s1, ld, hidden) and p2 (s2, hidden, ld) f32 where s1 / s2
// > 1 (else unused), pdb (ceil(m / 128), hidden) f32, pln (ceil(m /
// ln_rows), 3, ld) f32.
extern "C" int credit_fused_ff_bwd_bf16(
    const void* x, const void* ct, const void* gam, const void* bet, const void* w1,
    const void* b1, const void* w2, const void* b2, void* dx, void* dln, void* dw1, void* db1,
    void* dw2, void* y, void* a, void* dh, void* dy, void* p1, void* p2, void* pdb, void* pln,
    int m, int c, int ld, int hidden, int post_norm, int ln_rows, int bn_o2, int bn_dy,
    int bn_w1, int s1, int bn_w2, int s2, void* stream) {
  using B = __nv_bfloat16;
  if (m < 1 || c < 1 || ld < c || ld % 8 || hidden < 8 || hidden % 8 || s1 < 1 || s2 < 1 ||
      ln_rows < 1)
    return (int)cudaErrorInvalidValue;
  auto b = [](const void* p) { return static_cast<const B*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const ffb::Bf16Work w{static_cast<B*>(y), static_cast<B*>(a), static_cast<B*>(dh),
                        o(dy), o(p1), o(p2), o(pdb), o(pln)};
  const ffb::Bf16Plan p{ln_rows, bn_o2, bn_dy, bn_w1, s1, bn_w2, s2};
  const cudaError_t err = ffb::run_bf16(
      b(x), b(ct), b(gam), b(bet), b(w1), b(b1), b(w2), b(b2), static_cast<B*>(dx), o(dln),
      o(dw1), o(db1), o(dw2), w, p, m, c, ld, hidden, post_norm != 0,
      static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Bytes of workspace `credit_fused_ff_passes` needs for (m, ld, hidden), f32.
extern "C" long long credit_fused_ff_passes_workspace(int m, int ld, int hidden) {
  return (long long)ffb::fwd_plan(m, ld, hidden).total;
}

// The fused feed-forward's f32 forward in passes, for widths the fused
// kernel does not take. Operands as credit_fused_ff_bwd's: x, out (m, ld),
// the parameters zero-padded to ld and hidden (multiples of 8), c the true
// width. work: credit_fused_ff_passes_workspace bytes.
extern "C" int credit_fused_ff_passes(const void* x, const void* gam, const void* bet,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, void* out, void* work, int m, int c, int ld,
                                      int hidden, int post_norm, void* stream) {
  if (m < 1 || c < 1 || ld < c || ld % 8 || hidden < 8 || hidden % 8)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  ffb::run_fwd(f(x), f(gam), f(bet), f(w1), f(b1), f(w2), f(b2), static_cast<float*>(out),
               static_cast<unsigned char*>(work), m, c, ld, hidden, post_norm != 0,
               static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
