// Fused feed-forward with its residual, in the two forms of the TPU kernel:
//   pre-norm (CrossFormer):  x + fc2(GELU(fc1(LN(x))))
//   post-norm (SwinV2/FuXi): x + LN(fc2(GELU(fc1(x))))
//
// Replaces credit_tpu/ops/pallas_ff.py fused_ff (_ff_kernel at :58, the
// pallas_calls at :516 and :538), both forms. Every transformer FF of the
// flagship runs through the pre-norm form (28 calls per rollout step at
// C = 128..1024, hidden = 4C); every SwinV2 MLP of FuXi through the
// post-norm form (16 calls per step at C = 1024, M = 16905 tokens).
//
// Bound on the H100: operations. Each row does 4*C*H flops (H = 4C) against
// a few bytes of x and out, far above the card's ~295 FLOP/byte ridge once
// the hidden activations stay cheap to move.
//
// Two bf16 designs, picked per shape by cuda_ff.ff_plan:
//
// Fused (C < 256): a block owns BM token rows and keeps the 4C-wide hidden
// on chip; pre-norm computes the LN statistics in f32 (one warp per row) and
// keeps LN(x) in the input dtype in shared memory, post-norm keeps x itself
// there; then it walks the hidden dimension in chunks:
//   h = y . w1[:, chunk] + b1       (f32 accumulators)
//   GELU exact (erff), cast to the input dtype, into shared memory
//   acc += h . w2[chunk, :]         (f32 accumulators)
// and at the end adds b2 in f32; post-norm takes the LN of that f32 row (two
// passes over the row: the mean, then the mean of squared deviations, summed
// across the warps that share the row in shared memory, over the true C
// only); then it casts and adds the residual x in the input dtype -- the
// rounding points of the TPU kernel (pallas_ff.py:68-79). Both products run
// on mma.sync m16n8k16 with ldmatrix from shared memory. A block of 16 warps
// owns BM = 32768 / cpad rows (cpad = C padded to 128 or 256; the kernel
// also takes 512 and 1024, which the split route now runs faster). Its BM x cpad f32 output tile stays in
// registers, beside the f32 fc1 output of one hidden chunk of cpad/4
// columns. The weights stream through a 4-deep cp.async ring of K-slices;
// each block re-reads all the weights from L2, so the smaller BM is, the
// more L2 traffic: at C = 1024 (BM = 32, 16 MB of weights a block) that
// traffic bounded it at 12.4x its bound (PERF.md), which is why wider rows
// take the split route.
//
// Split (C >= 256, C % 8 != 0, C > 1024): LN rows, then fc1 and fc2 as two
// warp-specialised TMA + wgmma GEMMs (tma_gemm.cuh, the VALID conv's
// mainloop) whose epilogues add the biases, apply GELU, round and add the
// residual; the 4C-wide hidden goes to device memory once, in bf16 (138 MB
// for FuXi's 16,905 rows), and both products run at wgmma's rate. Post-norm
// writes fc2's f32 output and a row pass takes its LN. See "bf16, split".
//
// The wrapper zero-pads C; padded columns of the output are zero before the
// post-norm LN, which leaves them out of its statistics. f32 is plain FMA,
// 16 rows per block, accumulators in registers (C <= 1024); wider or ragged
// f32 widths run the same function in passes (credit_fused_ff_passes in
// fused_ff_bwd.cu).
#include "ff_rows.cuh"
#include "tma_gemm.cuh"

namespace credit {
namespace ff {

constexpr int THREADS_F32 = 256;  // the f32 kernel's block
constexpr int WARPS_F32 = THREADS_F32 / 32;
constexpr int MAX_C = 1024;

__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// LN(x) rows [m0, m0+BM) into y (input dtype, row stride ldy, zero-filled
// past C and past M). One warp per row, f32 statistics.
template <typename T>
__device__ void layer_norm_rows(const T* __restrict__ x, const T* __restrict__ gam,
                                const T* __restrict__ bet, T* y, int ldy, int m0, int bm, int m,
                                int c, int cpad) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < bm; r += WARPS_F32) {
    T* yr = y + r * ldy;
    if (m0 + r >= m) {
      for (int k = lane; k < cpad; k += 32) yr[k] = from_f32<T>(0.f);
      continue;
    }
    const T* xr = x + (size_t)(m0 + r) * c;
    float s = 0.f;
    for (int k = lane; k < c; k += 32) s += to_f32(xr[k]);
    const float mean = warp_sum(s) / c;
    float v = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float d = to_f32(xr[k]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / c + kEps);
    for (int k = lane; k < cpad; k += 32)
      yr[k] = k < c ? from_f32<T>((to_f32(xr[k]) - mean) * rstd * to_f32(gam[k]) + to_f32(bet[k]))
                    : from_f32<T>(0.f);
  }
}

// x rows [m0, m0+BM) into y as they are (post-norm: fc1 reads x), zero past M.
template <typename T>
__device__ void copy_rows(const T* __restrict__ x, T* y, int m0, int bm, int m, int c) {
  for (int i = threadIdx.x; i < bm * c; i += blockDim.x) {
    const int r = i / c;
    y[i] = m0 + r < m ? x[(size_t)m0 * c + i] : from_f32<T>(0.f);
  }
}

// ---------------------------------------------------------------- bf16
// The width is padded to cpad = 128, 256, 512 or 1024 (the wrapper pads the
// parameters with zeros) and a block owns BM = 32768 / cpad rows: RT = BM / 16
// row tiles of 16. The 16 warps form a WM x WN grid over them; each warp owns
// two m16 row tiles and, of the BM x cpad output, 8 n8 column tiles (64
// columns), of each BM x cpad/4 hidden chunk 2 n8 tiles (16 columns).
constexpr int THREADS_BF16 = 512;
constexpr int WARPS_BF16 = THREADS_BF16 / 32;
constexpr int NS = 4;  // depth of the weight-slice ring

template <int RT>
struct Tiling {
  static constexpr int BM = 16 * RT;
  static constexpr int CPAD = 2048 / RT;
  static constexpr int HC = CPAD / 4;  // hidden chunk
  static constexpr int WM = RT / 2;
  static constexpr int WN = WARPS_BF16 / WM;
  static constexpr int NF_OUT = 8, NF_HID = 2;  // n8 tiles per warp
  static_assert(WN * NF_OUT * 8 == CPAD && WN * NF_HID * 8 == HC, "warps tile the block");
};

// cpad for a width c (a multiple of 8), 0 past MAX_C
__host__ __device__ inline int padded_width(int c) {
  int cpad = 128;
  while (cpad < c) cpad *= 2;
  return cpad <= MAX_C ? cpad : 0;
}

// rows of w + 8 elements: 16 bytes of skew keep ldmatrix free of bank
// conflicts (the row stride is an odd number of 16-byte units) and every row
// 16-byte aligned
__host__ __device__ inline int ldw(int w) { return w + 8; }

// Weight slices: fc1 reads ks1 = 4 * ks2 rows of w1[:, chunk] (cpad/4 wide),
// fc2 ks2 rows of w2[chunk, :] (cpad wide): the same bytes, so one ring slot
// (ks2 * (cpad + 32) elements) holds either, and a chunk has nk = cpad / ks1
// slices of each.
__host__ __device__ inline size_t slot_elems(int cpad, int ks2) {
  return (size_t)ks2 * (cpad + 32);
}

__host__ inline size_t smem_bf16(int cpad, int ks2) {
  const int bm = 32768 / cpad;
  return ((size_t)bm * ldw(cpad) + (size_t)bm * ldw(cpad / 4) + NS * slot_elems(cpad, ks2)) *
         sizeof(__nv_bfloat16);
}

__host__ inline int slice_rows(int cpad) {  // ks2: 32 where the ring fits, else 16
  int ks2 = cpad / 4 < 32 ? cpad / 4 : 32;
  while (ks2 > 16 && smem_bf16(cpad, ks2) > (size_t)kMaxSmem) ks2 /= 2;
  return ks2;
}

// acc[i * NF + j] += A[m16 tile i, 0:ks] . B[0:ks, n8 tile j] over the warp's
// two row tiles and NF column tiles. a: the warp's first row of A at the
// slice's first K column (row stride lda); b: the slice's first row at the
// warp's first column (row stride ldb).
template <int NF>
__device__ __forceinline__ void warp_mma(float (&acc)[2 * NF][4], const __nv_bfloat16* a,
                                         int lda, const __nv_bfloat16* b, int ldb, int ks) {
  const int lane = threadIdx.x % 32;
  a += (lane % 16) * lda + (lane / 16) * 8;
  b += ((lane % 8) + ((lane / 8) % 2) * 8) * ldb + (lane / 16) * 8;
  for (int kk = 0; kk < ks; kk += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) ldmatrix_x4(af[i], a + i * 16 * lda + kk);
#pragma unroll
    for (int jp = 0; jp < NF / 2; ++jp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + kk * ldb + jp * 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i * NF + 2 * jp], af[i], bf[0], bf[1]);
        mma_bf16(acc[i * NF + 2 * jp + 1], af[i], bf[2], bf[3]);
      }
    }
  }
}

// Stage the block's x rows into y (row stride ld) with cp.async; rows past
// m and columns past c are zero-filled with plain stores.
__device__ inline void load_x_tile(__nv_bfloat16* y, const __nv_bfloat16* __restrict__ x, int m0,
                                   int bm, int m, int c, int cpad) {
  const int per_row = cpad / 8, ld = ldw(cpad);
  for (int i = threadIdx.x; i < bm * per_row; i += THREADS_BF16) {
    const int r = i / per_row, j = (i % per_row) * 8;
    __nv_bfloat16* dst = y + r * ld + j;
    if (m0 + r < m && j < c)
      cp_async16(dst, x + (size_t)(m0 + r) * c + j);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// LN over each staged row in place: one warp per row, 8 values per lane per
// 16-byte vector, f32 statistics from registers. Columns past c stay zero.
__device__ inline void layer_norm_in_place(__nv_bfloat16* y, const __nv_bfloat16* __restrict__ gam,
                                           const __nv_bfloat16* __restrict__ bet, int bm, int c,
                                           int ld) {
  constexpr int MAXV = MAX_C / 8 / 32;  // 16-byte vectors per lane
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = c / 8;
  for (int r = warp; r < bm; r += WARPS_BF16) {
    __nv_bfloat16* row = y + r * ld;
    float v[MAXV][8];
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < MAXV; ++q) {
      const int vi = lane + 32 * q;
      if (vi < nvec) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + vi * 8);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          v[q][t] = __bfloat162float(e[t]);
          sum += v[q][t];
        }
      }
    }
    const float mean = warp_sum(sum) / c;
    float var = 0.f;
#pragma unroll
    for (int q = 0; q < MAXV; ++q)
      if (lane + 32 * q < nvec)
#pragma unroll
        for (int t = 0; t < 8; ++t) var += (v[q][t] - mean) * (v[q][t] - mean);
    const float rstd = rsqrtf(warp_sum(var) / c + kEps);
#pragma unroll
    for (int q = 0; q < MAXV; ++q) {
      const int vi = lane + 32 * q;
      if (vi < nvec) {
        const uint4 graw = *reinterpret_cast<const uint4*>(gam + vi * 8);
        const uint4 braw = *reinterpret_cast<const uint4*>(bet + vi * 8);
        const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&graw);
        const __nv_bfloat16* be = reinterpret_cast<const __nv_bfloat16*>(&braw);
        uint4 raw;
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          e[t] = __float2bfloat16((v[q][t] - mean) * rstd * __bfloat162float(ge[t]) +
                                  __bfloat162float(be[t]));
        *reinterpret_cast<uint4*>(row + vi * 8) = raw;
      }
    }
  }
}

// x (m, c); w1 (cpad, hidden); w2 (hidden, cpad); gam, bet, b2 (cpad,);
// b1 (hidden,); cpad = Tiling<RT>::CPAD, hidden % (cpad / 4) == 0.
// POST: post-norm form (no input LN; LN of fc2's f32 output).
template <int RT, bool POST>
__global__ void __launch_bounds__(THREADS_BF16, 1)
fused_ff_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gam,
              const __nv_bfloat16* __restrict__ bet, const __nv_bfloat16* __restrict__ w1,
              const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
              const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ out, int m, int c,
              int hidden, int ks2) {
  using Tl = Tiling<RT>;
  constexpr int BM = Tl::BM, CPAD = Tl::CPAD, HC = Tl::HC;
  constexpr int NFO = Tl::NF_OUT, NFH = Tl::NF_HID;
  constexpr int LDY = CPAD + 8, LDH = HC + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sy = reinterpret_cast<__nv_bfloat16*>(smem);  // LN(x), later the output
  __nv_bfloat16* sh = sy + BM * LDY;                            // GELU of one hidden chunk
  __nv_bfloat16* ring = sh + BM * LDH;                          // NS weight slices
  const int slot = (int)slot_elems(CPAD, ks2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (warp / Tl::WN) * 32;         // the warp's first row in the block
  const int ocol0 = (warp % Tl::WN) * NFO * 8;   // and its first output column
  const int hcol0 = (warp % Tl::WN) * NFH * 8;   // and its first column of a chunk
  const int m0 = blockIdx.x * BM;
  const int ks1 = 4 * ks2;
  const int nk = CPAD / ks1;                     // slices per product and chunk
  const int total = (hidden / HC) * 2 * nk;      // slices in the whole stream

  // slice s: chunk s / (2 nk); fc1 (w1 rows) for its first nk, then fc2
  auto load_slice = [&](int s) {
    const int j = s % nk, h0 = (s / (2 * nk)) * HC;
    __nv_bfloat16* dst = ring + (s % NS) * slot;
    if ((s / nk) % 2 == 0) {  // ks1 x HC of w1
      for (int i = threadIdx.x; i < ks1 * (HC / 8); i += THREADS_BF16) {
        const int r = i / (HC / 8), v = (i % (HC / 8)) * 8;
        cp_async16(dst + r * LDH + v, w1 + (size_t)(j * ks1 + r) * hidden + h0 + v);
      }
    } else {  // ks2 x CPAD of w2
      for (int i = threadIdx.x; i < ks2 * (CPAD / 8); i += THREADS_BF16) {
        const int r = i / (CPAD / 8), v = (i % (CPAD / 8)) * 8;
        cp_async16(dst + r * LDY + v, w2 + (size_t)(h0 + j * ks2 + r) * CPAD + v);
      }
    }
  };

  load_x_tile(sy, x, m0, BM, m, c, CPAD);
  cp_async_commit();
  for (int s = 0; s < NS - 1; ++s) {
    if (s < total) load_slice(s);
    cp_async_commit();
  }
  cp_async_wait<NS - 1>();  // the x tile has landed
  __syncthreads();
  if constexpr (!POST) layer_norm_in_place(sy, gam, bet, BM, c, LDY);

  float hacc[2 * NFH][4], oacc[2 * NFO][4];
#pragma unroll
  for (int i = 0; i < 2 * NFO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;

  for (int s = 0; s < total; ++s) {
    cp_async_wait<NS - 2>();  // slice s has landed
    // every warp is done with slice s - 1's slot and, at a chunk's first
    // fc1 slice, with the previous chunk's GELU tile
    __syncthreads();
    if (s + NS - 1 < total) load_slice(s + NS - 1);
    cp_async_commit();
    const int j = s % nk;
    const __nv_bfloat16* w = ring + (s % NS) * slot;
    if ((s / nk) % 2 == 0) {  // fc1
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < 2 * NFH; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) hacc[i][e] = 0.f;
      }
      warp_mma<NFH>(hacc, sy + row0 * LDY + j * ks1, LDY, w + hcol0, LDH, ks1);
      if (j == nk - 1) {  // + b1, exact GELU, cast: the chunk's A operand of fc2
        const __nv_bfloat16* bias = b1 + (s / (2 * nk)) * HC;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int t = 0; t < NFH; ++t) {
            const int col = hcol0 + t * 8 + (lane % 4) * 2, r = row0 + i * 16 + lane / 4;
            const float c0 = __bfloat162float(bias[col]), c1 = __bfloat162float(bias[col + 1]);
            const float* h = hacc[i * NFH + t];
            *reinterpret_cast<uint32_t*>(sh + r * LDH + col) =
                pack_bf16(gelu(h[0] + c0), gelu(h[1] + c1));
            *reinterpret_cast<uint32_t*>(sh + (r + 8) * LDH + col) =
                pack_bf16(gelu(h[2] + c0), gelu(h[3] + c1));
          }
      }
    } else {  // fc2
      warp_mma<NFO>(oacc, sh + row0 * LDH + j * ks2, LDH, w + ocol0, LDY, ks2);
    }
  }

  // + b2 in f32; post-norm: LN of each f32 row; cast into the y tile, then
  // the residual in 16-byte vectors. Element e of oacc[i * NFO + t] sits at
  // row row0 + 16 i + lane / 4 + 8 (e / 2), column ocol0 + 8 t + 2 (lane % 4)
  // + e % 2.
  __syncthreads();  // every warp is done with the ring and the hidden tile
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < NFO; ++t) {
      const int col = ocol0 + t * 8 + (lane % 4) * 2;
      const float c0 = __bfloat162float(b2[col]), c1 = __bfloat162float(b2[col + 1]);
      float* o = oacc[i * NFO + t];
      o[0] += c0, o[1] += c1, o[2] += c0, o[3] += c1;
    }
  if constexpr (POST) {
    // the row's partial sums of the WN warps that share it, summed in a
    // fixed order; columns at or past c (zero-padded) are left out
    float* red = reinterpret_cast<float*>(ring);  // [BM][WN]
    const int wn = warp % Tl::WN;
    auto row_sums = [&](float (&v)[2][2]) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[i][h] += __shfl_xor_sync(0xffffffffu, v[i][h], 1);
          v[i][h] += __shfl_xor_sync(0xffffffffu, v[i][h], 2);
          if (lane % 4 == 0) red[(row0 + 16 * i + lane / 4 + 8 * h) * Tl::WN + wn] = v[i][h];
        }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* rr = red + (row0 + 16 * i + lane / 4 + 8 * h) * Tl::WN;
          float s = 0.f;
          for (int w = 0; w < Tl::WN; ++w) s += rr[w];
          v[i][h] = s;
        }
      __syncthreads();
    };
    float mean[2][2] = {}, rstd[2][2] = {};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < NFO; ++t)
        if (ocol0 + t * 8 < c) {  // c % 8 == 0: a column pair is in or out together
          const float* o = oacc[i * NFO + t];
          mean[i][0] += o[0] + o[1];
          mean[i][1] += o[2] + o[3];
        }
    row_sums(mean);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) mean[i][h] /= c;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < NFO; ++t)
        if (ocol0 + t * 8 < c) {
          const float* o = oacc[i * NFO + t];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float d = o[e] - mean[i][e / 2];
            rstd[i][e / 2] += d * d;
          }
        }
    row_sums(rstd);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) rstd[i][h] = rsqrtf(rstd[i][h] / c + kEps);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < NFO; ++t) {
        const int col = ocol0 + t * 8 + (lane % 4) * 2;
        const float g0 = __bfloat162float(gam[col]), g1 = __bfloat162float(gam[col + 1]);
        const float e0 = __bfloat162float(bet[col]), e1 = __bfloat162float(bet[col + 1]);
        float* o = oacc[i * NFO + t];
        o[0] = (o[0] - mean[i][0]) * rstd[i][0] * g0 + e0;
        o[1] = (o[1] - mean[i][0]) * rstd[i][0] * g1 + e1;
        o[2] = (o[2] - mean[i][1]) * rstd[i][1] * g0 + e0;
        o[3] = (o[3] - mean[i][1]) * rstd[i][1] * g1 + e1;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < NFO; ++t) {
      const int col = ocol0 + t * 8 + (lane % 4) * 2, r = row0 + i * 16 + lane / 4;
      const float* o = oacc[i * NFO + t];
      *reinterpret_cast<uint32_t*>(sy + r * LDY + col) = pack_bf16(o[0], o[1]);
      *reinterpret_cast<uint32_t*>(sy + (r + 8) * LDY + col) = pack_bf16(o[2], o[3]);
    }
  __syncthreads();
  const int vecs = c / 8;
  for (int e = threadIdx.x; e < BM * vecs; e += THREADS_BF16) {
    const int r = e / vecs, k = (e % vecs) * 8;
    if (m0 + r >= m) continue;
    const size_t at = (size_t)(m0 + r) * c + k;
    const uint4 xr = *reinterpret_cast<const uint4*>(x + at);
    const uint4 orr = *reinterpret_cast<const uint4*>(sy + r * LDY + k);
    const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xr);
    const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&orr);
    uint4 res;
    __nv_bfloat16* re = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
    for (int t = 0; t < 8; ++t)
      re[t] = __float2bfloat16(__bfloat162float(xe[t]) + __bfloat162float(oe[t]));
    *reinterpret_cast<uint4*>(out + at) = res;
  }
}

template <int RT, bool POST>
void launch_bf16(const void* x, const void* gam, const void* bet, const void* w1, const void* b1,
                 const void* w2, const void* b2, void* out, int m, int c, int hidden,
                 cudaStream_t s) {
  constexpr int CPAD = Tiling<RT>::CPAD, BM = Tiling<RT>::BM;
  const int ks2 = slice_rows(CPAD);
  const size_t smem = smem_bf16(CPAD, ks2);
  cudaFuncSetAttribute(fused_ff_bf16<RT, POST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  fused_ff_bf16<RT, POST><<<(m + BM - 1) / BM, THREADS_BF16, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gam),
      static_cast<const __nv_bfloat16*>(bet), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(out), m, c, hidden, ks2);
}

// ---------------------------------------------------------------- f32
constexpr int BM32 = 16;
constexpr int HC32 = 64;
constexpr int COLS32 = MAX_C / THREADS_F32;  // output columns per thread

template <bool POST>
__global__ void __launch_bounds__(THREADS_F32)
fused_ff_f32(const float* __restrict__ x, const float* __restrict__ gam,
             const float* __restrict__ bet, const float* __restrict__ w1,
             const float* __restrict__ b1, const float* __restrict__ w2,
             const float* __restrict__ b2, float* __restrict__ out, int m, int c, int hidden) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* y = reinterpret_cast<float*>(smem);  // (BM32, c)
  float* hs = y + BM32 * c;                   // (BM32, HC32)
  const int m0 = blockIdx.x * BM32;

  if constexpr (POST)
    copy_rows(x, y, m0, BM32, m, c);
  else
    layer_norm_rows(x, gam, bet, y, c, m0, BM32, m, c, c);

  float acc[BM32][COLS32];
#pragma unroll
  for (int r = 0; r < BM32; ++r)
#pragma unroll
    for (int j = 0; j < COLS32; ++j) acc[r][j] = 0.f;

  const int j1 = threadIdx.x % HC32, rq = threadIdx.x / HC32;  // 4 row quads
  for (int h0 = 0; h0 < hidden; h0 += HC32) {
    __syncthreads();
    if (h0 + j1 < hidden) {
      float h[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < c; ++k) {
        const float wv = w1[(size_t)k * hidden + h0 + j1];
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = fmaf(y[(rq * 4 + i) * c + k], wv, h[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) hs[(rq * 4 + i) * HC32 + j1] = gelu(h[i] + b1[h0 + j1]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) hs[(rq * 4 + i) * HC32 + j1] = 0.f;
    }
    __syncthreads();
    const int hn = min(HC32, hidden - h0);
    for (int j = 0; j < hn; ++j) {
#pragma unroll
      for (int q = 0; q < COLS32; ++q) {
        const int k = threadIdx.x + q * THREADS_F32;
        if (k < c) {
          const float wv = w2[(size_t)(h0 + j) * c + k];
#pragma unroll
          for (int r = 0; r < BM32; ++r) acc[r][q] = fmaf(hs[r * HC32 + j], wv, acc[r][q]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < COLS32; ++q) {
    const int k = threadIdx.x + q * THREADS_F32;
#pragma unroll
    for (int r = 0; r < BM32; ++r) acc[r][q] = k < c ? acc[r][q] + b2[k] : 0.f;
  }
  if constexpr (POST) {
    // LN of each f32 row: per-warp partial sums in shared memory, summed in
    // a fixed order; two passes (mean, then squared deviations)
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* red = hs;  // [BM32][WARPS_F32]
    float mean[BM32], rstd[BM32];
    auto row_sum = [&](float (&v)[BM32]) {
      __syncthreads();  // the previous readers of hs are done
#pragma unroll
      for (int r = 0; r < BM32; ++r) {
        const float s = warp_sum(v[r]);
        if (lane == 0) red[r * WARPS_F32 + warp] = s;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < BM32; ++r) {
        float s = 0.f;
        for (int w = 0; w < WARPS_F32; ++w) s += red[r * WARPS_F32 + w];
        v[r] = s;
      }
    };
#pragma unroll
    for (int r = 0; r < BM32; ++r) {
      mean[r] = 0.f;
#pragma unroll
      for (int q = 0; q < COLS32; ++q) mean[r] += acc[r][q];  // zero past c
    }
    row_sum(mean);
#pragma unroll
    for (int r = 0; r < BM32; ++r) {
      mean[r] /= c;
      rstd[r] = 0.f;
#pragma unroll
      for (int q = 0; q < COLS32; ++q) {
        const float d = acc[r][q] - mean[r];
        if (threadIdx.x + q * THREADS_F32 < c) rstd[r] += d * d;
      }
    }
    row_sum(rstd);
#pragma unroll
    for (int r = 0; r < BM32; ++r) rstd[r] = rsqrtf(rstd[r] / c + kEps);
#pragma unroll
    for (int q = 0; q < COLS32; ++q) {
      const int k = threadIdx.x + q * THREADS_F32;
      if (k >= c) continue;
#pragma unroll
      for (int r = 0; r < BM32; ++r)
        acc[r][q] = (acc[r][q] - mean[r]) * rstd[r] * gam[k] + bet[k];
    }
  }
#pragma unroll
  for (int q = 0; q < COLS32; ++q) {
    const int k = threadIdx.x + q * THREADS_F32;
    if (k >= c) continue;
#pragma unroll
    for (int r = 0; r < BM32; ++r) {
      if (m0 + r >= m) continue;
      const size_t at = (size_t)(m0 + r) * c + k;
      out[at] = x[at] + acc[r][q];
    }
  }
}

template <bool POST>
void launch_bf16_width(const void* x, const void* gam, const void* bet, const void* w1,
                       const void* b1, const void* w2, const void* b2, void* out, int m, int c,
                       int cpad, int hidden, cudaStream_t s) {
  switch (cpad) {
    case 128: launch_bf16<16, POST>(x, gam, bet, w1, b1, w2, b2, out, m, c, hidden, s); break;
    case 256: launch_bf16<8, POST>(x, gam, bet, w1, b1, w2, b2, out, m, c, hidden, s); break;
    case 512: launch_bf16<4, POST>(x, gam, bet, w1, b1, w2, b2, out, m, c, hidden, s); break;
    default: launch_bf16<2, POST>(x, gam, bet, w1, b1, w2, b2, out, m, c, hidden, s); break;
  }
}

template <bool POST>
void launch_f32(const void* x, const void* gam, const void* bet, const void* w1, const void* b1,
                const void* w2, const void* b2, void* out, int m, int c, int hidden,
                cudaStream_t s) {
  const size_t smem = (size_t)(BM32 * c + BM32 * HC32) * 4;
  cudaFuncSetAttribute(fused_ff_f32<POST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  fused_ff_f32<POST><<<(m + BM32 - 1) / BM32, THREADS_F32, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(gam),
      static_cast<const float*>(bet), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), m, c, hidden);
}

// ---------------------------------------------------------------- bf16, split
// The route for C >= 256, ragged C and C > 1024 (cuda_ff.ff_plan): the
// hidden activations leave the SM once, in bf16, and both products run on
// wgmma through tma_gemm.cuh's mainloop:
//   (pre-norm) ln_rows: y = LN(x) in bf16 (ff_rows.cuh);
//   fc1: H = GELU(A . w1 + b1) in bf16, A = y (pre-norm) or x (post-norm);
//   fc2: pre-norm out = x + bf16(H . w2 + b2); post-norm z = H . w2 in f32,
//        then out_rows: x + bf16(LN(z + b2)) (ff_rows.cuh).
// The rounding points are the fused kernel's. Every operand is row-major:
// A (rows x K) lands K-major in 128-row x 64 boxes, B (K x N) MN-major in
// 64 x 64 boxes; TMA zero-fills past M, K and N, so only stores are masked.
enum Epilogue { kEpiGelu = 0, kEpiResidual = 1, kEpiF32 = 2 };

struct GemmArgs {
  int m, n, steps;                 // output rows and columns, K steps of 64
  const __nv_bfloat16* bias;       // (n,): b1 (kEpiGelu) or b2 (kEpiResidual)
  const __nv_bfloat16* x;          // the residual (kEpiResidual), rows of n
  void* out;                       // H (bf16), out (bf16) or z (f32), rows of n
};

template <int BN, int EPI, int CTAS>
__global__ void __launch_bounds__(tma::Ring<BN, CTAS>::THREADS, CTAS)
ff_gemm(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
        const GemmArgs g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * 128;
  tma::gemm_tile<BN, CTAS>(
      smem_raw, g.steps,
      [&](int it, unsigned char* st, uint64_t* bar) {
        tma_load_2d(st, &ta, bar, it * tma::KS, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(st + tma::A_BYTES + j * tma::BOX_BYTES, &tb, bar, n0 + 64 * j,
                      it * tma::KS);
      },
      [&](float (&acc)[BN / 2], int cw) {
        const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + cw * 64 + warp * 16 + lane / 4 + 8 * h;
          if (row >= g.m) continue;
          const size_t at = (size_t)row * g.n;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * (lane % 4);  // n % 8 == 0: col + 1 is in range too
            if (col >= g.n) continue;
            const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
            if constexpr (EPI == kEpiF32) {
              *reinterpret_cast<float2*>(static_cast<float*>(g.out) + at + col) = make_float2(a0, a1);
            } else {
              const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(g.bias + col);
              const float v0 = a0 + __low2float(bb), v1 = a1 + __high2float(bb);
              uint32_t packed;
              if constexpr (EPI == kEpiGelu) {
                packed = pack_bf16(gelu(v0), gelu(v1));
              } else {  // bf16(o), then + x in bf16
                const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(g.x + at + col);
                packed = pack_bf16(__low2float(xv) + __bfloat162float(__float2bfloat16(v0)),
                                   __high2float(xv) + __bfloat162float(__float2bfloat16(v1)));
              }
              *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(g.out) + at + col) = packed;
            }
          }
        }
      });
}

// A launch of ff_gemm<BN, EPI, CTAS> over g's output
template <int BN, int EPI, int CTAS>
cudaError_t launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb, const GemmArgs& g,
                        cudaStream_t s) {
  using R = tma::Ring<BN, CTAS>;
  cudaFuncSetAttribute(ff_gemm<BN, EPI, CTAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)R::SMEM);
  const dim3 grid((g.n + BN - 1) / BN, (g.m + 127) / 128);  // the N tile fastest
  ff_gemm<BN, EPI, CTAS><<<grid, R::THREADS, R::SMEM, s>>>(ta, tb, g);
  return cudaGetLastError();
}

// fc2: bn output columns a block (64, 128, 192 or 256), one block an SM
template <int EPI>
cudaError_t launch_fc2(int bn, const CUtensorMap& ta, const CUtensorMap& tb, const GemmArgs& g,
                       cudaStream_t s) {
  switch (bn) {
    case 64: return launch_gemm<64, EPI, 1>(ta, tb, g, s);
    case 128: return launch_gemm<128, EPI, 1>(ta, tb, g, s);
    case 192: return launch_gemm<192, EPI, 1>(ta, tb, g, s);
    case 256: return launch_gemm<256, EPI, 1>(ta, tb, g, s);
    default: return cudaErrorInvalidValue;
  }
}

using tma::operand_map;

cudaError_t split_fc1(const __nv_bfloat16* in, const __nv_bfloat16* w1, const __nv_bfloat16* b1,
                      __nv_bfloat16* h, int m, int ld, int hidden, cudaStream_t s) {
  CUtensorMap ta, tb;
  if (!operand_map(&ta, in, m, ld, 128) || !operand_map(&tb, w1, ld, hidden, 64))
    return cudaErrorInvalidValue;
  return launch_gemm<128, kEpiGelu, 2>(
      ta, tb, GemmArgs{m, hidden, (ld + tma::KS - 1) / tma::KS, b1, nullptr, h}, s);
}

cudaError_t split_fc2_f32(const __nv_bfloat16* h, const __nv_bfloat16* w2, float* z, int m,
                          int ld, int hidden, int bn2, cudaStream_t s) {
  CUtensorMap ta, tb;
  if (!operand_map(&ta, h, m, hidden, 128) || !operand_map(&tb, w2, hidden, ld, 64))
    return cudaErrorInvalidValue;
  return launch_fc2<kEpiF32>(
      bn2, ta, tb, GemmArgs{m, ld, (hidden + tma::KS - 1) / tma::KS, nullptr, nullptr, z}, s);
}

}  // namespace ff
}  // namespace credit

using namespace credit;

// The fused kernel. bf16: x (m, c), out (m, c); gam, bet, b2 (cpad,), w1
// (cpad, hidden), b1 (hidden,), w2 (hidden, cpad), cpad = c padded to 128,
// 256, 512 or 1024 (cuda_ff.ff_plan), zero-padded, hidden a multiple of
// cpad / 4; every pointer 16-byte aligned. f32: the same with cpad == c and any hidden.
// post_norm: 0 for x + fc2(GELU(fc1(LN(x)))), 1 for x + LN(fc2(GELU(fc1(x)))).
extern "C" int credit_fused_ff(const void* x, const void* gam, const void* bet, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* out,
                               int dtype, int m, int c, int cpad, int hidden, int post_norm,
                               void* stream) {
  using namespace credit::ff;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || c < 1 || c > MAX_C || c % 8) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16) {
    if (cpad != padded_width(c) || hidden % (cpad / 4)) return (int)cudaErrorInvalidValue;
    if (post_norm)
      launch_bf16_width<true>(x, gam, bet, w1, b1, w2, b2, out, m, c, cpad, hidden, s);
    else
      launch_bf16_width<false>(x, gam, bet, w1, b1, w2, b2, out, m, c, cpad, hidden, s);
  } else if (dtype == kF32) {
    if (cpad != c) return (int)cudaErrorInvalidValue;
    if (post_norm)
      launch_f32<true>(x, gam, bet, w1, b1, w2, b2, out, m, c, hidden, s);
    else
      launch_f32<false>(x, gam, bet, w1, b1, w2, b2, out, m, c, hidden, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The split route, bf16 (see above): x, out (m, ld); gam, bet, b2 (ld,), w1
// (ld, hidden), b1 (hidden,), w2 (hidden, ld), zero-padded past the true
// width c; ld and hidden multiples of 8, every pointer 16-byte aligned.
// Workspace from the caller: y (m, ld) bf16 (pre-norm; else unused), h (m,
// hidden) bf16, z (m, ld) f32 (post-norm; else unused). fc1 runs 128 x 128
// tiles, two blocks an SM, so that one block's GELU epilogue runs beside the
// other's products; bn2: fc2's output columns a block (cuda_ff.ff_plan).
extern "C" int credit_fused_ff_split(const void* x, const void* gam, const void* bet,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* out, void* y, void* h, void* z, int m,
                                     int c, int ld, int hidden, int post_norm, int bn2,
                                     void* stream) {
  using namespace credit::ff;
  using B = __nv_bfloat16;
  if (m < 1 || c < 1 || ld < c || ld % 8 || hidden < 8 || hidden % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const B* fc1_in = static_cast<const B*>(x);
  if (!post_norm) {
    (ld > c ? ln_rows<B, true> : ln_rows<B, false>)<<<(m + ROW_WARPS - 1) / ROW_WARPS,
                                                     ROW_THREADS, 0, s>>>(
        static_cast<const B*>(x), static_cast<const B*>(gam), static_cast<const B*>(bet),
        static_cast<B*>(y), m, c, ld);
    fc1_in = static_cast<const B*>(y);
  }
  cudaError_t err = split_fc1(fc1_in, static_cast<const B*>(w1), static_cast<const B*>(b1),
                              static_cast<B*>(h), m, ld, hidden, s);
  if (err != cudaSuccess) return (int)err;
  if (post_norm) {
    err = split_fc2_f32(static_cast<const B*>(h), static_cast<const B*>(w2), static_cast<float*>(z),
                        m, ld, hidden, bn2, s);
    if (err != cudaSuccess) return (int)err;
    out_rows<B, true><<<(m + ROW_WARPS - 1) / ROW_WARPS, ROW_THREADS, 0, s>>>(
        static_cast<const B*>(x), static_cast<const float*>(z), static_cast<const B*>(b2),
        static_cast<const B*>(gam), static_cast<const B*>(bet), static_cast<B*>(out), m, c, ld);
  } else {
    CUtensorMap ta2, tb2;
    if (!operand_map(&ta2, h, m, hidden, 128) || !operand_map(&tb2, w2, hidden, ld, 64))
      return (int)cudaErrorInvalidValue;
    err = launch_fc2<kEpiResidual>(
        bn2, ta2, tb2,
        GemmArgs{m, ld, (hidden + tma::KS - 1) / tma::KS, static_cast<const B*>(b2),
                 static_cast<const B*>(x), out},
        s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
