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
// o2 = a.w2 as well: 12 M C H.
//
// Design, right and simple first. The TPU kernel keeps the 4C-wide h1, GELU
// and dh1 in VMEM and sums the weight gradients across a grid that runs in
// order. On Hopper blocks run in parallel and a block cannot hold a C x 4C
// f32 partial (256 KB at C = 128), so the weight gradients are split-K
// products over the rows, and the work is a chain of passes on the caller's
// stream. Pre-norm:
//   1. LN rows: y = LN(x) in x's dtype (one warp per row, f32 statistics);
//   2. h1 = y.w1 + b1 and da = ct.w2^T in one block tile (two tensor-core
//      products), then a = GELU(h1) and dh1 = da * GELU'(h1), written to two
//      M x H intermediates in x's dtype, with the column sums of the f32 dh1
//      (db1) per row tile;
//   3. dy = dh1.w1^T (f32, M x C);
//   4. the LN backward per row: dx = ct + rstd (dy g - mean(dy g) - xhat
//      mean(dy g xhat)), and per row block the column sums of dy xhat (dg),
//      dy (db) and ct (db2);
//   5. dw1 = y^T.dh1 and dw2 = a^T.ct, split over the rows into partials;
//   6. every partial summed in a fixed order, so the result does not change
//      from run to run.
// Post-norm (y = x, no input LN; the cotangent passes the output LN first):
//   1. a = GELU(x.w1 + b1) in x's dtype;
//   2. o2 = a.w2 (f32, M x C);
//   3. per row: o2 + b2, its LN statistics (two passes) and ohat; do2 = the
//      LN backward of ct g, in x's dtype, with per row block the column sums
//      of ct ohat (dg), ct (db) and the f32 do2 (db2);
//   4. pass 2 of pre-norm with y = x and do2 as the cotangent: dh1 and db1;
//   5. dy = dh1.w1^T; 6. dx = ct + dy;
//   7. dw1 = x^T.dh1 and dw2 = a^T.do2, split over the rows; 8. the sums.
// Unlike the TPU kernel it writes the M x 4C intermediates a and dh1 (and
// M x C of y or do2 and of f32 dy or o2) to device memory: at the WXFormer's
// stage 0 in bf16 that is ~2.0 GB of extra traffic per call (PERF.md counts
// it).
//
// Numerics are the TPU kernel's (pallas_ff.py:239-294): y, a, ct, do2 and dh1
// are in x's dtype where they enter a product; LN statistics, Phi, the pdf
// and every accumulator are f32; erf is the exact erff, where the TPU kernel
// used Abramowitz-Stegun 7.1.26 (1.5e-7 absolute). Any M is taken: ragged row
// tiles are masked. Any C is taken: rows are zero-padded to ld, a multiple of
// 8 (the wrapper's copy), the statistics run over the true C, and the LN
// backward splits rows wider than 2048 into column slices over its grid. The
// same passes give the f32 forward at widths the fused kernel does not take
// (credit_fused_ff_passes, at the end). bf16 runs the products on mma.sync
// m16n8k16 with ldmatrix through a 3-deep cp.async ring; f32 runs them on FMA.
#include <algorithm>

#include "ff_rows.cuh"

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
// 22-62% slower on the H100.
constexpr int LN_ROWS = 64;
constexpr int LN_CW = 2048;

__host__ __device__ inline int ln_cols(int ld) { return ld < LN_CW ? ld : LN_CW; }

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

// LN backward, one warp per row, LN_ROWS rows per block:
// dx = ct + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), dxhat = dy g.
// Column sums of dy xhat, dy and ct over the block's rows go to
// part[block][0..3 ld) (dg | db | db2), summed over the warps in order.
template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS)
ln_bwd_rows(const T* __restrict__ x, const T* __restrict__ ct, const float* __restrict__ dy,
            const T* __restrict__ gam, T* __restrict__ dx, float* __restrict__ part, int m,
            int c, int ld) {
  extern __shared__ __align__(16) float cols[];  // [WARPS][3][cw]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cw = WIDE ? ln_cols(ld) : c;
  const int c0 = WIDE ? blockIdx.y * LN_CW : 0, c1 = WIDE ? min(ld, c0 + cw) : c;
  float* mine = cols + (size_t)warp * 3 * cw;
  for (int k = lane; k < 3 * cw; k += 32) mine[k] = 0.f;
  const int r0 = blockIdx.x * LN_ROWS;
  for (int r = r0 + warp; r < min(m, r0 + LN_ROWS); r += WARPS) {
    const T* xr = x + (size_t)r * ld;
    const T* cr = ct + (size_t)r * ld;
    const float* dr = dy + (size_t)r * ld;
    float mean, rstd;
    ROW_STATS(to_f32(xr[k]), c, mean, rstd);
    float s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float xhat = (to_f32(xr[k]) - mean) * rstd, d = dr[k];
      const float dxh = d * to_f32(gam[k]);
      s1 += dxh;
      s2 += dxh * xhat;
      if (!WIDE || (k >= c0 && k < c1)) {
        mine[k - c0] += d * xhat;
        mine[cw + k - c0] += d;
        mine[2 * cw + k - c0] += to_f32(cr[k]);
      }
    }
    const float m1 = warp_sum(s1) / c, m2 = warp_sum(s2) / c;
    for (int k = c0 + lane; k < (WIDE ? min(c, c1) : c); k += 32) {
      const float xhat = (to_f32(xr[k]) - mean) * rstd;
      const float dxh = dr[k] * to_f32(gam[k]);
      dx[(size_t)r * ld + k] = from_f32<T>(to_f32(cr[k]) + rstd * (dxh - m1 - xhat * m2));
    }
    if constexpr (WIDE)
      for (int k = max(c, c0) + lane; k < c1; k += 32) dx[(size_t)r * ld + k] = from_f32<T>(0.f);
  }
  store_col_sums(cols, part, cw, c0, c1, ld);
}

// Post-norm LN backward, one warp per row, LN_ROWS rows per block: with
// o = o2 + b2, ohat = (o - mean) rstd and dohat = ct g,
// do2 = rstd (dohat - mean(dohat) - ohat mean(dohat ohat)) in x's dtype.
// Column sums of ct ohat, ct and the f32 do2 over the block's rows go to
// part[block][0..3 ld) (dg | db | db2), summed over the warps in order.
template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS)
ln_post_bwd_rows(const float* __restrict__ o2, const T* __restrict__ b2, const T* __restrict__ ct,
                 const T* __restrict__ gam, T* __restrict__ do2, float* __restrict__ part, int m,
                 int c, int ld) {
  extern __shared__ __align__(16) float cols[];  // [WARPS][3][cw]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cw = WIDE ? ln_cols(ld) : c;
  const int c0 = WIDE ? blockIdx.y * LN_CW : 0, c1 = WIDE ? min(ld, c0 + cw) : c;
  float* mine = cols + (size_t)warp * 3 * cw;
  for (int k = lane; k < 3 * cw; k += 32) mine[k] = 0.f;
  const int r0 = blockIdx.x * LN_ROWS;
  for (int r = r0 + warp; r < min(m, r0 + LN_ROWS); r += WARPS) {
    const float* orow = o2 + (size_t)r * ld;
    const T* cr = ct + (size_t)r * ld;
    float mean, rstd;
    ROW_STATS(orow[k] + to_f32(b2[k]), c, mean, rstd);
    float s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float ohat = (orow[k] + to_f32(b2[k]) - mean) * rstd, g = to_f32(cr[k]);
      const float doh = g * to_f32(gam[k]);
      s1 += doh;
      s2 += doh * ohat;
      if (!WIDE || (k >= c0 && k < c1)) {
        mine[k - c0] += g * ohat;
        mine[cw + k - c0] += g;
      }
    }
    const float m1 = warp_sum(s1) / c, m2 = warp_sum(s2) / c;
    for (int k = c0 + lane; k < (WIDE ? min(c, c1) : c); k += 32) {
      const float ohat = (orow[k] + to_f32(b2[k]) - mean) * rstd;
      const float d = rstd * (to_f32(cr[k]) * to_f32(gam[k]) - m1 - ohat * m2);
      mine[2 * cw + k - c0] += d;
      do2[(size_t)r * ld + k] = from_f32<T>(d);
    }
    if constexpr (WIDE)
      for (int k = max(c, c0) + lane; k < c1; k += 32) do2[(size_t)r * ld + k] = from_f32<T>(0.f);
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

// out[i] = sum over s < nsum of part[s * n + i], in that order
__global__ void sum_parts(const float* __restrict__ part, float* __restrict__ out, size_t n,
                          int nsum) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nsum; ++k) s += part[(size_t)k * n + i];
    out[i] = s;
  }
}

// ---------------------------------------------------------------- bf16 products
// A block tile of BM = 32 MT rows x BN = 32 NT columns; 8 warps as 2 (rows)
// x 4 (columns), each MT m16 x NT n8 tiles. Operands are read through a
// 3-deep cp.async ring of BK = 32 deep slices. A is (M, K) row-major, or
// stored (K, M) when AT; B is (K, N) row-major, or stored (N, K) when BT.
// Extents along a stored row must be multiples of 8 (16-byte vectors).
constexpr int BK = 32;
constexpr int NSTAGE = 3;

template <int MT, int NT>
struct Tile {
  static constexpr int BM = 32 * MT, BN = 32 * NT;
  // a slice of A or B in either layout, with 8 elements of row skew
  static constexpr int A_ELEMS = BM * (BK + 8) > BK * (BM + 8) ? BM * (BK + 8) : BK * (BM + 8);
  static constexpr int B_ELEMS = BN * (BK + 8) > BK * (BN + 8) ? BN * (BK + 8) : BK * (BN + 8);
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr size_t SMEM = (size_t)NSTAGE * STAGE * sizeof(__nv_bfloat16);
};

// rows [r0, r0 + nr) x 8-element vectors of a (rows, cols) row-major array
// with row stride ld into dst (row stride ldd), zero past (rows, cols)
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ldd,
                                          const __nv_bfloat16* __restrict__ src, int ld, int r0,
                                          int nr, int c0, int nc, int rows, int cols) {
  const int per = nc / 8;
  for (int i = threadIdx.x; i < nr * per; i += THREADS) {
    const int r = i / per, v = (i % per) * 8;
    __nv_bfloat16* d = dst + r * ldd + v;
    if (r0 + r < rows && c0 + v < cols)
      cp_async16(d, src + (size_t)(r0 + r) * ld + c0 + v);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// acc += A[m0:m0+BM, k0:k1] . B[k0:k1, n0:n0+BN]; smem holds NSTAGE stages.
// Columns of A / rows of B at or past k1 read as zero.
template <bool AT, bool BT, int MT, int NT>
__device__ void mma_loop(float (&acc)[MT][NT][4], const __nv_bfloat16* __restrict__ A, int lda,
                         const __nv_bfloat16* __restrict__ B, int ldb, int M, int N, int m0,
                         int n0, int k0, int k1, __nv_bfloat16* smem) {
  using Tl = Tile<MT, NT>;
  constexpr int BM = Tl::BM, BN = Tl::BN;
  constexpr int LDA = AT ? BM + 8 : BK + 8, LDB = BT ? BK + 8 : BN + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int nk = (k1 - k0 + BK - 1) / BK;

  auto load = [&](int s) {
    __nv_bfloat16* sa = smem + (s % NSTAGE) * Tl::STAGE;
    __nv_bfloat16* sb = sa + Tl::A_ELEMS;
    const int kb = k0 + s * BK;
    if (AT)  // stored (K, M): BK rows of BM
      load_tile(sa, LDA, A, lda, kb, BK, m0, BM, k1, M);
    else  // (M, K): BM rows of BK
      load_tile(sa, LDA, A, lda, m0, BM, kb, BK, M, k1);
    if (BT)  // stored (N, K): BN rows of BK
      load_tile(sb, LDB, B, ldb, n0, BN, kb, BK, N, k1);
    else  // (K, N): BK rows of BN
      load_tile(sb, LDB, B, ldb, kb, BK, n0, BN, k1, N);
  };

  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    if (s + NSTAGE - 1 < nk) load(s + NSTAGE - 1);
    cp_async_commit();
    const __nv_bfloat16* sa = smem + (s % NSTAGE) * Tl::STAGE;
    const __nv_bfloat16* sb = sa + Tl::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mr = wm * 16 * MT + i * 16;
        if (AT)  // [k][m]: lane -> k (l % 8) + (l / 16) 8, m ((l / 8) % 2) 8
          ldmatrix_x4_trans(af[i], sa + (kk + lane % 8 + (lane / 16) * 8) * LDA + mr +
                                       ((lane / 8) % 2) * 8);
        else  // [m][k]: lane -> m l % 16, k (l / 16) 8
          ldmatrix_x4(af[i], sa + (mr + lane % 16) * LDA + kk + (lane / 16) * 8);
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        const int nc = wn * 8 * NT + jp * 16;
        uint32_t bf[4];
        if (BT)  // [n][k]: lane -> n (l % 8) + (l / 16) 8, k ((l / 8) % 2) 8
          ldmatrix_x4(bf, sb + (nc + lane % 8 + (lane / 16) * 8) * LDB + kk +
                              ((lane / 8) % 2) * 8);
        else  // [k][n]: lane -> k (l % 8) + ((l / 8) % 2) 8, n (l / 16) 8
          ldmatrix_x4_trans(bf, sb + (kk + lane % 8 + ((lane / 8) % 2) * 8) * LDB + nc +
                                    (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  __syncthreads();  // the ring may be reused by the caller
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Element e of acc[i][j] sits at row m0 + 16 MT wm + 16 i + lane / 4 + 8 (e / 2)
// and column n0 + 8 NT wn + 8 j + 2 (lane % 4) + e % 2.

// Pass 2: h1 = y.w1 + b1, da = ct.w2^T; a = GELU(h1), dh1 = da GELU'(h1)
// into (m, hidden) arrays (a only where a_out is given); the column sums of
// dh1 over this block's rows into dbpart[blockIdx.y][hidden]. GRAD = false
// (post-norm pass 1): h1 and a only.
constexpr int G_MT = 4, G_NT = 2;  // 128 x 64 tiles

template <bool GRAD>
__global__ void __launch_bounds__(THREADS)
gelu_bwd_bf16(const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ ct,
              const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
              const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ a_out,
              __nv_bfloat16* __restrict__ dh_out, float* __restrict__ dbpart, int m, int c,
              int hidden) {
  using Tl = Tile<G_MT, G_NT>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * Tl::BM, n0 = blockIdx.x * Tl::BN;
  float h[G_MT][G_NT][4], d[G_MT][G_NT][4];
  zero(h);
  zero(d);
  mma_loop<false, false>(h, y, c, w1, hidden, m, hidden, m0, n0, 0, c, smem);
  if constexpr (GRAD) mma_loop<false, true>(d, ct, c, w2, c, m, hidden, m0, n0, 0, c, smem);
  // row group (wm, lane / 4) x column: one writer each, summed in order below
  float* red = reinterpret_cast<float*>(smem_raw);  // [16][BN]
  float colsum[G_NT][2];
#pragma unroll
  for (int j = 0; j < G_NT; ++j) colsum[j][0] = colsum[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < G_MT; ++i)
#pragma unroll
    for (int j = 0; j < G_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm * 16 * G_MT + i * 16 + lane / 4 + 8 * (e / 2);
        const int col = n0 + wn * 8 * G_NT + j * 8 + 2 * (lane % 4) + e % 2;
        if (r >= m || col >= hidden) continue;
        const float h1 = h[i][j][e] + __bfloat162float(b1[col]);
        const float p = phi_of(h1);
        if (a_out != nullptr) a_out[(size_t)r * hidden + col] = __float2bfloat16(h1 * p);
        if constexpr (GRAD) {
          const float dh = d[i][j][e] * (p + h1 * expf(-0.5f * h1 * h1) * kInvSqrt2Pi);
          dh_out[(size_t)r * hidden + col] = __float2bfloat16(dh);
          colsum[j][e % 2] += dh;
        }
      }
  if constexpr (!GRAD) return;
#pragma unroll
  for (int j = 0; j < G_NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      red[(wm * 8 + lane / 4) * Tl::BN + wn * 8 * G_NT + j * 8 + 2 * (lane % 4) + e] = colsum[j][e];
  __syncthreads();
  for (int col = threadIdx.x; col < Tl::BN; col += THREADS) {
    if (n0 + col >= hidden) continue;
    float s = 0.f;
    for (int g = 0; g < 16; ++g) s += red[g * Tl::BN + col];
    dbpart[(size_t)blockIdx.y * hidden + n0 + col] = s;
  }
}

// Passes 3 and 5: out[z] (M x N f32) = A . B over this split's share of K
constexpr int P_MT = 4, P_NT = 4;  // 128 x 128 tiles

template <bool AT, bool BT>
__global__ void __launch_bounds__(THREADS)
gemm_bf16(const __nv_bfloat16* __restrict__ A, int lda, const __nv_bfloat16* __restrict__ B,
          int ldb, float* __restrict__ out, int M, int N, int K, int kper) {
  using Tl = Tile<P_MT, P_NT>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * Tl::BM, n0 = blockIdx.x * Tl::BN;
  const int k0 = blockIdx.z * kper, k1 = min(K, k0 + kper);
  float acc[P_MT][P_NT][4];
  zero(acc);
  if (k0 < k1)
    mma_loop<AT, BT>(acc, A, lda, B, ldb, M, N, m0, n0, k0, k1,
                     reinterpret_cast<__nv_bfloat16*>(smem_raw));
  float* o = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < P_MT; ++i)
#pragma unroll
    for (int j = 0; j < P_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm * 16 * P_MT + i * 16 + lane / 4 + 8 * (e / 2);
        const int col = n0 + wn * 8 * P_NT + j * 8 + 2 * (lane % 4) + e % 2;
        if (r < M && col < N) o[(size_t)r * N + col] = acc[i][j][e];
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

// ---------------------------------------------------------------- plan
inline size_t al(size_t v) { return align_up(v, 256); }

// Every offset and extent below is in the padded width ld (see the rows).
struct Plan {
  int bm_gelu, bn_gelu, tile;  // pass-2 tile and the product tile (square)
  int row_tiles, ln_blocks;
  int s1, s2;    // splits of dw1 (C x H) and dw2 (H x C) over the rows
  size_t y, a, dh, dy, p1, p2, pdb, pln, total;  // workspace offsets, bytes
};

inline int splits_for(int rows, int cols, int tile, int m) {
  const int tiles = ((rows + tile - 1) / tile) * ((cols + tile - 1) / tile);
  const int s = (2 * 132 + tiles - 1) / tiles;
  return std::max(1, std::min(s, m / 512));
}

inline Plan plan(int dtype, int m, int ld, int hidden) {
  Plan p{};
  const size_t esz = dtype == kBF16 ? 2 : 4;
  p.bm_gelu = dtype == kBF16 ? Tile<G_MT, G_NT>::BM : F_B;
  p.bn_gelu = dtype == kBF16 ? Tile<G_MT, G_NT>::BN : F_B;
  p.tile = dtype == kBF16 ? Tile<P_MT, P_NT>::BM : F_B;
  p.row_tiles = (m + p.bm_gelu - 1) / p.bm_gelu;
  p.ln_blocks = (m + LN_ROWS - 1) / LN_ROWS;
  p.s1 = splits_for(ld, hidden, p.tile, m);
  p.s2 = splits_for(hidden, ld, p.tile, m);
  size_t o = 0;
  p.y = o, o += al((size_t)m * ld * esz);
  p.a = o, o += al((size_t)m * hidden * esz);
  p.dh = o, o += al((size_t)m * hidden * esz);
  p.dy = o, o += al((size_t)m * ld * 4);
  p.p1 = o, o += p.s1 > 1 ? al((size_t)p.s1 * ld * hidden * 4) : 0;
  p.p2 = o, o += p.s2 > 1 ? al((size_t)p.s2 * hidden * ld * 4) : 0;
  p.pdb = o, o += al((size_t)p.row_tiles * hidden * 4);
  p.pln = o, o += al((size_t)p.ln_blocks * 3 * ld * 4);
  p.total = o;
  return p;
}

inline void sum_into(const float* part, float* out, size_t n, int nsum, cudaStream_t s) {
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  sum_parts<<<blocks, 256, 0, s>>>(part, out, n, nsum);
}

inline int kper_for(int k, int splits, int bk) {
  const int per = (k + splits - 1) / splits;
  return (per + bk - 1) / bk * bk;
}

inline size_t ln_smem(int ld) { return (size_t)WARPS * 3 * ln_cols(ld) * 4; }

template <typename T>
void run(const T* x, const T* ct, const T* gam, const T* bet, const T* w1, const T* b1,
         const T* w2, const T* b2, T* dx, float* dln, float* dw1, float* db1, float* dw2,
         unsigned char* work, int m, int c, int ld, int hidden, bool post, cudaStream_t s) {
  constexpr bool BF = sizeof(T) == 2;
  const Plan p = plan(BF ? kBF16 : kF32, m, ld, hidden);
  // pre-norm: y = LN(x); post-norm: the slot holds do2 and fc1 reads x
  T* y = reinterpret_cast<T*>(work + p.y);
  T* a = reinterpret_cast<T*>(work + p.a);
  T* dh = reinterpret_cast<T*>(work + p.dh);
  // post-norm: o2 first, dy once o2 is consumed
  float* dy = reinterpret_cast<float*>(work + p.dy);
  float* p1 = p.s1 > 1 ? reinterpret_cast<float*>(work + p.p1) : dw1;
  float* p2 = p.s2 > 1 ? reinterpret_cast<float*>(work + p.p2) : dw2;
  float* pdb = reinterpret_cast<float*>(work + p.pdb);
  float* pln = reinterpret_cast<float*>(work + p.pln);
  const T* fc1_in = post ? x : y;
  const T* grad_out = post ? y : ct;  // the cotangent of fc2's output

  const dim3 g2((hidden + p.bn_gelu - 1) / p.bn_gelu, p.row_tiles);
  const dim3 g3((ld + p.tile - 1) / p.tile, (m + p.tile - 1) / p.tile, 1);
  const int tk = BF ? BK : F_K;
  const int kp1 = kper_for(m, p.s1, tk), kp2 = kper_for(m, p.s2, tk);
  const dim3 g5a((hidden + p.tile - 1) / p.tile, (ld + p.tile - 1) / p.tile, p.s1);
  const dim3 g5b((ld + p.tile - 1) / p.tile, (hidden + p.tile - 1) / p.tile, p.s2);
  const size_t smln = ln_smem(ld);
  const bool wide = ld > c || ld > LN_CW;  // the LN backward's padded or column-sliced form
  const dim3 gln(p.ln_blocks, (ld + LN_CW - 1) / LN_CW);
  const size_t sm2 = Tile<G_MT, G_NT>::SMEM, smp = Tile<P_MT, P_NT>::SMEM;
  if constexpr (BF) {
    cudaFuncSetAttribute(gelu_bwd_bf16<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)sm2);
    cudaFuncSetAttribute(gemm_bf16<false, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smp);
    cudaFuncSetAttribute(gemm_bf16<true, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smp);
  }
  if (post) {
    // 1. a = GELU(x.w1 + b1); 2. o2 = a.w2; 3. do2 and the dg / db / db2 partials
    if constexpr (BF) {
      cudaFuncSetAttribute(gelu_bwd_bf16<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sm2);
      gelu_bwd_bf16<false><<<g2, THREADS, sm2, s>>>(x, ct, w1, b1, w2, a, nullptr, nullptr, m, ld,
                                                    hidden);
      cudaFuncSetAttribute(gemm_bf16<false, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smp);
      gemm_bf16<false, false><<<g3, THREADS, smp, s>>>(a, hidden, w2, ld, dy, m, ld, hidden,
                                                       hidden);
    } else {
      gelu_bwd_f32<false><<<g2, THREADS, 0, s>>>(x, ct, w1, b1, w2, a, nullptr, nullptr, m, ld,
                                                 hidden);
      gemm_f32<false, false><<<g3, THREADS, 0, s>>>(a, hidden, w2, ld, dy, m, ld, hidden, hidden);
    }
    auto kern = wide ? ln_post_bwd_rows<T, true> : ln_post_bwd_rows<T, false>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smln);
    kern<<<gln, THREADS, smln, s>>>(dy, b2, ct, gam, y, pln, m, c, ld);
  } else {
    // 1. y = LN(x)
    (ld > c ? ff::ln_rows<T, true> : ff::ln_rows<T, false>)<<<(m + WARPS - 1) / WARPS, THREADS, 0, s>>>(
        x, gam, bet, y, m, c, ld);
  }
  // 2. dh1 and the db1 partials (a as well, pre-norm); 3. dy = dh1 . w1^T;
  // 5. dw1 = y^T . dh1 (C x H), dw2 = a^T . grad_out (H x C), split over rows
  T* a_out = post ? nullptr : a;
  if constexpr (BF) {
    gelu_bwd_bf16<true><<<g2, THREADS, sm2, s>>>(fc1_in, grad_out, w1, b1, w2, a_out, dh, pdb, m,
                                                 ld, hidden);
    gemm_bf16<false, true><<<g3, THREADS, smp, s>>>(dh, hidden, w1, hidden, dy, m, ld, hidden,
                                                    hidden);
    gemm_bf16<true, false><<<g5a, THREADS, smp, s>>>(fc1_in, ld, dh, hidden, p1, ld, hidden, m,
                                                     kp1);
    gemm_bf16<true, false><<<g5b, THREADS, smp, s>>>(a, hidden, grad_out, ld, p2, hidden, ld, m,
                                                     kp2);
  } else {
    gelu_bwd_f32<true><<<g2, THREADS, 0, s>>>(fc1_in, grad_out, w1, b1, w2, a_out, dh, pdb, m, ld,
                                              hidden);
    gemm_f32<false, true><<<g3, THREADS, 0, s>>>(dh, hidden, w1, hidden, dy, m, ld, hidden,
                                                 hidden);
    gemm_f32<true, false><<<g5a, THREADS, 0, s>>>(fc1_in, ld, dh, hidden, p1, ld, hidden, m, kp1);
    gemm_f32<true, false><<<g5b, THREADS, 0, s>>>(a, hidden, grad_out, ld, p2, hidden, ld, m,
                                                  kp2);
  }
  if (post) {
    // 6. dx = ct + dy
    const size_t n = (size_t)m * ld;
    add_rows<T><<<(int)std::min<size_t>((n + 255) / 256, 4096), 256, 0, s>>>(ct, dy, dx, n);
  } else {
    // 4. dx and the dg / db / db2 partials
    auto kern = wide ? ln_bwd_rows<T, true> : ln_bwd_rows<T, false>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smln);
    kern<<<gln, THREADS, smln, s>>>(x, ct, dy, gam, dx, pln, m, c, ld);
  }
  // the partials, in a fixed order
  if (p.s1 > 1) sum_into(p1, dw1, (size_t)ld * hidden, p.s1, s);
  if (p.s2 > 1) sum_into(p2, dw2, (size_t)hidden * ld, p.s2, s);
  sum_into(pdb, db1, hidden, p.row_tiles, s);
  sum_into(pln, dln, (size_t)3 * ld, p.ln_blocks, s);
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

// Bytes of workspace `credit_fused_ff_bwd` needs for (m, ld, hidden).
extern "C" long long credit_fused_ff_bwd_workspace(int dtype, int m, int ld, int hidden) {
  return (long long)ffb::plan(dtype, m, ld, hidden).total;
}

// x, ct, dx (m, ld); gam, bet, b2 (ld,); w1 (ld, hidden); b1 (hidden,); w2
// (hidden, ld), all of one dtype (kF32 or kBF16), contiguous, 16-byte
// aligned; ld and hidden multiples of 8, ld >= c, the true width: columns
// past c and the parameters' rows / columns there are zero, and stay out of
// every statistic (b2 shifts no statistic in pre-norm form, which does not
// read it). post_norm: 0 for the backward of x + fc2(GELU(fc1(LN(x)))), 1
// for x + LN(fc2(GELU(fc1(x)))). Outputs f32: dln (3, ld) = dg | db | db2,
// dw1 (ld, hidden), db1 (hidden,), dw2 (hidden, ld); zero past c. work:
// credit_fused_ff_bwd_workspace bytes.
extern "C" int credit_fused_ff_bwd(const void* x, const void* ct, const void* gam,
                                   const void* bet, const void* w1, const void* b1,
                                   const void* w2, const void* b2, void* dx, void* dln, void* dw1,
                                   void* db1, void* dw2, void* work, int dtype, int m, int c,
                                   int ld, int hidden, int post_norm, void* stream) {
  if (m < 1 || c < 1 || ld < c || ld % 8 || hidden < 8 || hidden % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* wk = static_cast<unsigned char*>(work);
  auto fl = [](void* p) { return static_cast<float*>(p); };
  if (dtype == kBF16) {
    using B = __nv_bfloat16;
    ffb::run<B>(static_cast<const B*>(x), static_cast<const B*>(ct), static_cast<const B*>(gam),
                static_cast<const B*>(bet), static_cast<const B*>(w1), static_cast<const B*>(b1),
                static_cast<const B*>(w2), static_cast<const B*>(b2), static_cast<B*>(dx),
                fl(dln), fl(dw1), fl(db1), fl(dw2), wk, m, c, ld, hidden, post_norm != 0, s);
  } else if (dtype == kF32) {
    ffb::run<float>(static_cast<const float*>(x), static_cast<const float*>(ct),
                    static_cast<const float*>(gam), static_cast<const float*>(bet),
                    static_cast<const float*>(w1), static_cast<const float*>(b1),
                    static_cast<const float*>(w2), static_cast<const float*>(b2),
                    static_cast<float*>(dx), fl(dln), fl(dw1), fl(db1), fl(dw2), wk, m, c, ld,
                    hidden, post_norm != 0, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
