// Windowed multi-head attention with one (T, T) bias shared by every window
// and head: per (window, head), softmax(q * dh^-0.5 . k^T + bias) . v.
//
// Replaces credit_tpu/ops/pallas_attention.py fused_window_attention
// (_attn_kernel at :46, the pallas_call at :122). The flagship runs it
// twice per transformer block, 28 calls per rollout step, at T = 100
// (local windows and the stage-0 long windows), 25, 4 and 1, dh = 32.
//
// Bound on the H100: bytes. Each call reads q, k, v and writes the output
// once (~295 MB at stage 0 in bf16) against ~4*T*dh flops per token; the
// (T, T) scores are what an unfused composition would move; here they never
// leave the SM. q, k, v are read straight from the (B, nWin, T, heads*dh)
// layout with a token stride, so the fused qkv projection is never split or
// transposed. Scores in f32, a safe softmax with exact division, p rounded
// to v's dtype, p . v accumulated in f32; q is scaled in its own dtype
// first, as the TPU kernel does (pallas_attention.py:56-58).
//
// bf16 with dh = 16, 32, 64 or 128 (window_attention_mma) is built to keep
// bytes in flight. Persistent blocks walk work items; an item is one window
// (or, for T <= 8, a pack of 16 / T windows) x a group of heads spanning 64
// or 128 columns (4 heads of 32 at the flagship's stage 0), so every row of
// q, k and v is one contiguous 128- or 256-byte segment. One producer warp
// issues TMA loads of the 3-D boxes {64 columns, rows, windows} of q, k and
// v (a tensor map over (windows, T, columns) with the token stride: rows
// past T come as zeros, so a window is never read into its neighbour's
// rows) into a ring of two or more stages guarded by mbarriers; while the
// consumer warps compute on one item the next one's q, k and v land. The
// boxes land with 128-byte swizzle and every ldmatrix address applies it.
// For T <= 128 the block builds the bias table once for its whole life in
// shared memory: (16 RT) x (16 RT + 8) f32 (row stride 8 mod 32 banks, so
// the fragments' float2 reads are conflict-free), -inf at padded keys and
// between the windows of a pack. Consumer warps take (head, 16-row query
// tile) pairs: q fragments by ldmatrix (scaled and rounded in registers),
// S = Q K^T on mma.sync m16n8k16 (the kernel is bytes-bound: wgmma's 64-row
// tiles would pad T = 100 to 128 for nothing), the softmax on the registers
// with quad shuffles, P rounded to bf16 and re-packed as the A operand of
// P V. Each pair writes its output tile over its own q tile; once every
// warp is done, one thread stores the item by TMA (rows past T are not
// written) and frees the stage.
//
// Windows past 128 tokens run over key blocks of 64 keys with an online
// softmax (FlashAttention-2): query blocks of up to 128 rows are the items,
// k and v blocks stream through their own ring, each pair keeps a running
// max m and sum l in f32 and its output in f32 registers, p = exp(s - m) is
// rounded to bf16 before P V, and the output is divided by l at the end.
// For T <= 128 (one key block: every window of every path) the numerics
// are the exact form above.
//
// f32, and bf16 at other head widths, strides or column groups, take plain
// FMA (window_attention_fma): a block stages one problem's keys and values a
// key block at a time and walks the query rows in chunks, one warp per row,
// scores in shared memory, the bias read through the cache; the exact form
// where the keys fit one block (the plan makes the block as large as shared
// memory allows), else the same online softmax with p rounded to the input
// dtype. The TPU kernel's block-diagonal window grouping, which exists to
// give the MXU 128-wide shapes, survives only as the T <= 8 packs.
// cuda_attention.attention_plan picks the kernel and every size.
#include <cmath>

#include "common.cuh"

namespace credit {
namespace attn {

// ------------------------------------------------------------------ FMA
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;  // query rows a warp holds at once over key blocks
// blocks an SM the registers allow (the launch bound holds the kernel to
// 40): the blocks walk the problems, so the plan's grid must all be resident
constexpr int FMA_BLOCKS_PER_SM = 6;

// query rows a warp holds: ROWS in the online form, one in the exact form
// (its state then costs no shared memory a second block of the SM could use)
__host__ __device__ inline int fma_rows(int t, int kb) { return kb >= t ? 1 : ROWS; }

__host__ __device__ inline int ldk(int dh) { return dh + 1; }

// one key block's k and v, and per warp its rows' scaled q and f32 output
// sums, their running max and sum, and one row of scores
__host__ inline size_t fma_smem(int t, int kb, int dh) {
  return (2 * (size_t)kb * ldk(dh) + (size_t)WARPS * (2 * fma_rows(t, kb) * (dh + 1) + kb)) * 4;
}

// The row loops stay rolled (a warp's state lives in shared memory): unrolled
// they took 102 registers and a quarter of the resident warps.
template <typename T>
__global__ void __launch_bounds__(THREADS, FMA_BLOCKS_PER_SM)
window_attention_fma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, T* __restrict__ out, int problems,
                     int heads, int t, int dh, int in_stride, int out_stride, float scale,
                     int kb) {
  extern __shared__ __align__(16) float sm[];
  float* sk = sm;                  // (kb, dh+1)
  float* sv = sk + kb * ldk(dh);   // (kb, dh+1)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = fma_rows(t, kb);
  float* sq = sv + kb * ldk(dh) + warp * (2 * rw * (dh + 1) + kb);  // this warp's scaled q rows
  float* so = sq + rw * dh;        // and their output sums
  float* sml = so + rw * dh;       // running max and sum of each row (online form)
  float* prow = sml + 2 * rw;      // one row of scores
  const T scale_t = from_f32<T>(scale);
  const int nkb = (t + kb - 1) / kb;

  for (int pr = blockIdx.x; pr < problems; pr += gridDim.x) {
    const int win = pr / heads, h = pr % heads;
    const size_t col = (size_t)h * dh;
    for (int q0 = 0; q0 < t; q0 += WARPS * rw) {
      const int rows = min(rw, t - q0 - warp * rw);  // this warp's rows in the chunk
#pragma unroll 1
      for (int r = 0; r < rows; ++r) {
        const int i = q0 + warp * rw + r;
        // q * scale rounded to q's dtype, then widened
        for (int d = lane; d < dh; d += 32) {
          sq[r * dh + d] = to_f32(from_f32<T>(
              to_f32(q[((size_t)win * t + i) * in_stride + col + d]) * to_f32(scale_t)));
          so[r * dh + d] = 0.f;
        }
        if (lane == 0) sml[2 * r] = -INFINITY, sml[2 * r + 1] = 0.f;
      }
      for (int kbi = 0; kbi < nkb; ++kbi) {
        const int j0 = kbi * kb, nk = min(kb, t - j0);
        if (nkb > 1 || q0 == 0) {  // one block of keys stays for every chunk
          __syncthreads();         // every warp is done with the previous block
          for (int e = threadIdx.x; e < nk * dh; e += THREADS) {
            const int row = e / dh, d = e % dh;
            const size_t at = ((size_t)win * t + j0 + row) * in_stride + col + d;
            sk[row * ldk(dh) + d] = to_f32(k[at]);
            sv[row * ldk(dh) + d] = to_f32(v[at]);
          }
          __syncthreads();
        }
        __syncwarp();
#pragma unroll 1
        for (int r = 0; r < rows; ++r) {
          const int i = q0 + warp * rw + r;
          const float* qr = sq + r * dh;
          float mx = -INFINITY;
          for (int j = lane; j < nk; j += 32) {
            float acc = 0.f;
            for (int d = 0; d < dh; ++d) acc = fmaf(qr[d], sk[j * ldk(dh) + d], acc);
            prow[j] = acc + bias[(size_t)i * t + j0 + j];
            mx = fmaxf(mx, prow[j]);
          }
          mx = warp_max(mx);
          const size_t orow = ((size_t)win * t + i) * out_stride + col;
          if (nkb == 1) {  // the exact form
            float sum = 0.f;
            for (int j = lane; j < nk; j += 32) {
              prow[j] = expf(prow[j] - mx);
              sum += prow[j];
            }
            sum = warp_sum(sum);
            // p rounded to v's dtype before the P.V product
            for (int j = lane; j < nk; j += 32) prow[j] = to_f32(from_f32<T>(prow[j] / sum));
            __syncwarp();
            for (int d = lane; d < dh; d += 32) {
              float acc = 0.f;
              for (int j = 0; j < nk; ++j) acc = fmaf(prow[j], sv[j * ldk(dh) + d], acc);
              out[orow + d] = from_f32<T>(acc);
            }
          } else {  // online: rescale the sums to the new max
            const float mold = sml[2 * r], mnew = fmaxf(mold, mx), corr = expf(mold - mnew);
            float sum = 0.f;
            for (int j = lane; j < nk; j += 32) {
              const float e = expf(prow[j] - mnew);
              sum += e;
              prow[j] = to_f32(from_f32<T>(e));  // p rounded before P.V
            }
            sum = warp_sum(sum);
            __syncwarp();
            for (int d = lane; d < dh; d += 32) {
              float acc = 0.f;
              for (int j = 0; j < nk; ++j) acc = fmaf(prow[j], sv[j * ldk(dh) + d], acc);
              so[r * dh + d] = so[r * dh + d] * corr + acc;
            }
            if (lane == 0) sml[2 * r] = mnew, sml[2 * r + 1] = sml[2 * r + 1] * corr + sum;
          }
          __syncwarp();  // prow and the row's state are rewritten next
        }
      }
      if (nkb > 1) {
#pragma unroll 1
        for (int r = 0; r < rows; ++r) {
          const int i = q0 + warp * rw + r;
          for (int d = lane; d < dh; d += 32)
            out[((size_t)win * t + i) * out_stride + col + d] =
                from_f32<T>(so[r * dh + d] / sml[2 * r + 1]);
        }
      }
      __syncwarp();  // sq and so are rewritten by the next chunk
    }
  }
}

// ------------------------------------------------------------ bf16, mma
// A tile of an item lands as column boxes of 64 (128 bytes a row), `rows`
// rows each, 128-byte swizzled: the byte offset of element (row, col).
__device__ __forceinline__ int swz(int rows, int row, int col) {
  const int c = col & 63;
  return (col >> 6) * rows * 128 + row * 128 + ((((c >> 3) ^ (row & 7))) << 4) + (c & 7) * 2;
}

constexpr int MULTI_KT = 4;  // past one key block: blocks of 64 keys

template <int DH>
struct Mma {
  static constexpr int CAP = DH <= 32 ? 14 : 8;  // consumer warps at most
  static constexpr int PMAX = DH >= 128 ? 1 : 2;  // pairs a warp holds over key blocks
  static constexpr int THREADS = 32 * (CAP + 1);
};

// One call's plan (cuda_attention.attention_plan) and operands.
struct MmaArgs {
  const float* bias;  // (t, t) f32
  int t;
  int wpi;      // windows an item packs (t <= 8), else 1
  int hg;       // heads an item holds: 64 or 128 columns
  int groups;   // head groups: heads / hg
  int rt;       // 16-row query tiles an item
  int nq;       // query blocks a window
  int nkb;      // key blocks a window; 1: the exact form
  int items;    // work items: window packs x groups x query blocks
  int slots;    // stages of each ring
  float scale;  // dh^-0.5, rounded to bf16 in the kernel
};

__host__ __device__ inline int mma_qbytes(const MmaArgs& a, int dh) {
  return a.hg * dh / 64 * 16 * a.rt * 128;
}
// dynamic shared memory: 1 KB to align, the rings' stages, the bias table
// (one key block only), the barriers; kt: 16-key tiles a key block
__host__ inline size_t mma_smem(const MmaArgs& a, int dh, int kt) {
  const size_t kv = (size_t)a.hg * dh / 64 * 16 * kt * 128 * 2;
  const size_t table = a.nkb == 1 ? (size_t)16 * a.rt * (16 * a.rt + 8) * 4 : 0;
  return 1024 + a.slots * (mma_qbytes(a, dh) + kv) + table + 4 * a.slots * sizeof(uint64_t);
}

__device__ __forceinline__ void scale_rows(uint32_t (&r)[4], float sc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 p = *reinterpret_cast<__nv_bfloat162*>(&r[i]);
    r[i] = pack_bf16(__low2float(p) * sc, __high2float(p) * sc);
  }
}

// q fragments of the pair's row tile (rows rt * 16..), head columns c0..,
// scaled and rounded to bf16 as the TPU kernel does
template <int DH>
__device__ __forceinline__ void load_q(uint32_t (&qa)[DH / 16][4], const unsigned char* qt,
                                       int qr, int rt, int c0, float sc) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kd = 0; kd < DH / 16; ++kd) {
    ldmatrix_x4(qa[kd], reinterpret_cast<const __nv_bfloat16*>(
                            qt + swz(qr, rt * 16 + lane % 16, c0 + kd * 16 + (lane / 16) * 8)));
    scale_rows(qa[kd], sc);
  }
}

// s += Q K^T over the KT key tiles of the block (n8 tile j: keys 8j..8j+7)
template <int KT, int DH>
__device__ __forceinline__ void qk(float (&s)[2 * KT][4], const uint32_t (&qa)[DH / 16][4],
                                   const unsigned char* kt, int c0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kp = 0; kp < KT; ++kp)
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) {
      uint32_t kb[4];  // K rows are B's columns: the plain (untransposed) load
      ldmatrix_x4(kb, reinterpret_cast<const __nv_bfloat16*>(
                          kt + swz(16 * KT, kp * 16 + lane % 8 + (lane / 16) * 8,
                                   c0 + kd * 16 + ((lane / 8) % 2) * 8)));
      mma_bf16(s[2 * kp], qa[kd], kb[0], kb[1]);
      mma_bf16(s[2 * kp + 1], qa[kd], kb[2], kb[3]);
    }
}

// o += P V, P given as the probability of each score (already scaled)
template <int KT, int DH>
__device__ __forceinline__ void pv(float (&o)[DH / 8][4], const float (&s)[2 * KT][4], float f0,
                                   float f1, const unsigned char* vt, int c0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kp = 0; kp < KT; ++kp) {
    uint32_t pa[4];  // p rounded to bf16 before the product
    pa[0] = pack_bf16(s[2 * kp][0] * f0, s[2 * kp][1] * f0);
    pa[1] = pack_bf16(s[2 * kp][2] * f1, s[2 * kp][3] * f1);
    pa[2] = pack_bf16(s[2 * kp + 1][0] * f0, s[2 * kp + 1][1] * f0);
    pa[3] = pack_bf16(s[2 * kp + 1][2] * f1, s[2 * kp + 1][3] * f1);
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, reinterpret_cast<const __nv_bfloat16*>(
                                vt + swz(16 * KT, kp * 16 + lane % 8 + ((lane / 8) % 2) * 8,
                                         c0 + dp * 16 + (lane / 16) * 8)));
      mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
      mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
}

// max and sum across the quad that holds a row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the pair's output rows (o / the row's divisor) over its own q tile
template <int DH>
__device__ __forceinline__ void store_o(unsigned char* qt, int qr, int rt, int c0,
                                        const float (&o)[DH / 8][4], float d0, float d1) {
  const int lane = threadIdx.x % 32, r = rt * 16 + lane / 4;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    const int col = c0 + d * 8 + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(qt + swz(qr, r, col)) = pack_bf16(o[d][0] / d0, o[d][1] / d0);
    *reinterpret_cast<uint32_t*>(qt + swz(qr, r + 8, col)) = pack_bf16(o[d][2] / d1, o[d][3] / d1);
  }
}

// a / b rounded to nearest for b >= 1, given y = 1 / b rounded to nearest:
// one FMA correction of a * y (Markstein), the correctly rounded quotient
// wherever it does not underflow -- what a / b gives, without the
// reciprocal the compiler would repeat for every element
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = a * y;
  return fmaf(fmaf(-b, q, a), y, q);
}

// The exact form (one key block): the bias table, the exact max and sum, p =
// bf16(e / sum), P V in f32 -- today's numerics. rows: the item's valid rows
// (keys); n8 key tiles wholly past them skip their exponentials (a branch
// per tile: one per element cost more than it saved).
template <int KT, int DH>
__device__ __forceinline__ void exact_pair(unsigned char* qt, const unsigned char* kt,
                                           const unsigned char* vt, const float* table, int head,
                                           int rt, int rows, float sc) {
  constexpr int QR = 16 * KT, LDB = QR + 8;
  const int lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const int c0 = head * DH, r = rt * 16 + g;
  const int live = (rows + 7) / 8;
  uint32_t qa[DH / 16][4];
  load_q<DH>(qa, qt, QR, rt, c0, sc);
  float s[2 * KT][4];  // S = bias + Q K^T
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    const float2 lo = *reinterpret_cast<const float2*>(table + r * LDB + j * 8 + 2 * qd);
    const float2 hi = *reinterpret_cast<const float2*>(table + (r + 8) * LDB + j * 8 + 2 * qd);
    s[j][0] = lo.x, s[j][1] = lo.y, s[j][2] = hi.x, s[j][3] = hi.y;
  }
  qk<KT, DH>(s, qa, kt, c0);
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
  mx[0] = quad_max(mx[0]), mx[1] = quad_max(mx[1]);
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    if (j < live) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e / 2]);  // exp(-inf) = 0: masked keys
        sum[e / 2] += s[j][e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
  }
  sum[0] = quad_sum(sum[0]), sum[1] = quad_sum(sum[1]);
  const float y[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = div_rn(s[j][e], sum[e / 2], y[e / 2]);
  float o[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  pv<KT, DH>(o, s, 1.f, 1.f, vt, c0);
  store_o<DH>(qt, QR, rt, c0, o, 1.f, 1.f);
}

// A pair's running state over key blocks (the online form).
template <int DH>
struct Online {
  uint32_t qa[DH / 16][4];
  float o[DH / 8][4];
  float m[2], l[2];
};

// One key block of the online form: the bias read through the cache, -inf
// past T; m, l and o rescaled to the new max; p = bf16(exp(s - m)).
template <int KT, int DH>
__device__ __forceinline__ void online_step(Online<DH>& st, const unsigned char* kt,
                                            const unsigned char* vt, const float* __restrict__ bias,
                                            int t, int row0, int key0, int c0) {
  const int lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  float s[2 * KT][4];
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = row0 + g + 8 * (e / 2), key = key0 + j * 8 + 2 * qd + (e & 1);
      s[j][e] = key >= t ? -INFINITY : (i < t ? __ldg(bias + (size_t)i * t + key) : 0.f);
    }
  qk<KT, DH>(s, st.qa, kt, c0);
  float mx[2] = {st.m[0], st.m[1]}, sum[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    corr[h] = expf(st.m[h] - mx[h]);  // 0 at the first block (m = -inf)
    st.m[h] = mx[h];
  }
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - mx[e / 2]);
      sum[e / 2] += s[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * corr[h] + quad_sum(sum[h]);
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[d][e] *= corr[e / 2];
  pv<KT, DH>(st.o, s, 1.f, 1.f, vt, c0);
}

template <int KT, int DH>
__global__ void __launch_bounds__(Mma<DH>::THREADS, 1)
window_attention_mma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                     const MmaArgs a) {
  constexpr int KR = 16 * KT;  // keys a block
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const bool single = a.nkb == 1;
  const int qr = 16 * a.rt, gc = a.hg * DH, nb = gc / 64;
  const int qbytes = mma_qbytes(a, DH), kvbytes = nb * KR * 128;
  // what TMA moves a stage: boxes of a pack's t x wpi rows, else of qr / KR
  const uint32_t qtx = nb * 128 * (a.wpi > 1 ? a.t * a.wpi : qr);
  const uint32_t kvtx = 2 * nb * 128 * (a.wpi > 1 ? a.t * a.wpi : KR);
  unsigned char* qslots = smem;
  unsigned char* kvslots = smem + a.slots * qbytes;  // each: k, then v
  float* table = reinterpret_cast<float*>(kvslots + a.slots * 2 * kvbytes);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(table + (single ? qr * (qr + 8) : 0));
  uint64_t* qempty = qfull + a.slots;
  uint64_t* kvfull = qempty + a.slots;
  uint64_t* kvempty = kvfull + a.slots;
  const int consumers = blockDim.x / 32 - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // zeros where no box lands (a pack's rows past t * wpi), and the bias
  // table: the bias within a window, -inf at padded keys and across the
  // windows of a pack, 0 on padded query rows (never stored)
  for (int i = threadIdx.x; i < a.slots * (qbytes + 2 * kvbytes) / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  if (single) {
    const int rows = a.wpi * a.t;
    for (int i = threadIdx.x; i < qr * qr; i += blockDim.x) {
      const int r = i / qr, j = i % qr;
      table[r * (qr + 8) + j] =
          r >= rows ? 0.f
                    : (j >= rows || j / a.t != r / a.t ? -INFINITY
                                                       : a.bias[(r % a.t) * a.t + j % a.t]);
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.slots; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], 1);  // the thread that stores the item's output
      mbar_init(&kvfull[s], 1);
      mbar_init(&kvempty[s], consumers);
    }
    mbar_fence_init();
  }
  fence_proxy_async();  // the zeros before any TMA write
  __syncthreads();

  if (warp == 0) {  // producer
    if (lane == 0) {
      int qs = 0, ks = 0;
      uint32_t qph = 0, kph = 0;
      for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
        const int qb = item % a.nq, g = item / a.nq % a.groups, w0 = item / a.nq / a.groups * a.wpi;
        const int q0 = a.wpi > 1 ? 0 : qb * qr;
        mbar_wait(&qempty[qs], qph ^ 1);
        mbar_expect_tx(&qfull[qs], qtx);
        for (int b = 0; b < nb; ++b)
          tma_load_3d(qslots + qs * qbytes + b * qr * 128, &tq, &qfull[qs], g * gc + 64 * b, q0, w0);
        if (++qs == a.slots) qs = 0, qph ^= 1;
        for (int kb = 0; kb < a.nkb; ++kb) {
          unsigned char* kv = kvslots + ks * 2 * kvbytes;
          mbar_wait(&kvempty[ks], kph ^ 1);
          mbar_expect_tx(&kvfull[ks], kvtx);
          for (int b = 0; b < nb; ++b) {
            tma_load_3d(kv + b * KR * 128, &tk, &kvfull[ks], g * gc + 64 * b, kb * KR, w0);
            tma_load_3d(kv + kvbytes + b * KR * 128, &tv, &kvfull[ks], g * gc + 64 * b, kb * KR,
                        w0);
          }
          if (++ks == a.slots) ks = 0, kph ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warp cw takes pairs cw, cw + consumers, ... of each item
  const int cw = warp - 1, pairs = a.hg * a.rt;
  const float sc = __bfloat162float(__float2bfloat16(a.scale));
  int qs = 0, ks = 0;
  uint32_t qph = 0, kph = 0;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int qb = item % a.nq, g = item / a.nq % a.groups, w0 = item / a.nq / a.groups * a.wpi;
    unsigned char* qt = qslots + qs * qbytes;
    mbar_wait(&qfull[qs], qph);
    if (single) {
      const unsigned char* kt = kvslots + ks * 2 * kvbytes;
      mbar_wait(&kvfull[ks], kph);
      for (int p = cw; p < pairs; p += consumers)
        exact_pair<KT, DH>(qt, kt, kt + kvbytes, table, p / a.rt, p % a.rt, a.wpi * a.t, sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kvempty[ks]);
      if (++ks == a.slots) ks = 0, kph ^= 1;
    } else if constexpr (KT == MULTI_KT) {
      constexpr int PMAX = Mma<DH>::PMAX;
      Online<DH> st[PMAX];
#pragma unroll
      for (int j = 0; j < PMAX; ++j) {
        const int p = cw + j * consumers;
        if (p >= pairs) continue;
        load_q<DH>(st[j].qa, qt, qr, p % a.rt, p / a.rt * DH, sc);
        st[j].m[0] = st[j].m[1] = -INFINITY;
        st[j].l[0] = st[j].l[1] = 0.f;
#pragma unroll
        for (int d = 0; d < DH / 8; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j].o[d][e] = 0.f;
      }
      for (int kb = 0; kb < a.nkb; ++kb) {
        const unsigned char* kt = kvslots + ks * 2 * kvbytes;
        mbar_wait(&kvfull[ks], kph);
#pragma unroll
        for (int j = 0; j < PMAX; ++j) {
          const int p = cw + j * consumers;
          if (p < pairs)
            online_step<KT, DH>(st[j], kt, kt + kvbytes, a.bias, a.t, qb * qr + p % a.rt * 16,
                                kb * KR, p / a.rt * DH);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&kvempty[ks]);
        if (++ks == a.slots) ks = 0, kph ^= 1;
      }
#pragma unroll
      for (int j = 0; j < PMAX; ++j) {
        const int p = cw + j * consumers;
        if (p < pairs) store_o<DH>(qt, qr, p % a.rt, p / a.rt * DH, st[j].o, st[j].l[0], st[j].l[1]);
      }
    }
    // every pair's output is over its q tile: one thread stores the item
    fence_proxy_async();
    named_sync(1, consumers * 32);
    if (cw == 0 && lane == 0) {
      const int q0 = a.wpi > 1 ? 0 : qb * qr;
      for (int b = 0; b < nb; ++b) tma_store_3d(&to, qt + b * qr * 128, g * gc + 64 * b, q0, w0);
      bulk_commit();
      bulk_wait_read();  // the stage may be loaded again
      mbar_arrive(&qempty[qs]);
    }
    if (++qs == a.slots) qs = 0, qph ^= 1;
  }
  if (cw == 0 && lane == 0) bulk_wait_all();
}

template <int KT, int DH>
cudaError_t launch_mma(const CUtensorMap* maps, const MmaArgs& a, int consumers, int grid,
                       cudaStream_t s) {
  auto kern = window_attention_mma<KT, DH>;
  const size_t smem = mma_smem(a, DH, KT);
  if (smem > (size_t)kMaxSmem || consumers < 1 || consumers > Mma<DH>::CAP ||
      (a.nkb > 1 && (KT != MULTI_KT || a.hg * a.rt > consumers * Mma<DH>::PMAX)) ||
      (a.nkb == 1 && a.rt != KT))
    return cudaErrorInvalidValue;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<grid, 32 * (consumers + 1), smem, s>>>(maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_mma_dh(int dh, const CUtensorMap* maps, const MmaArgs& a, int consumers,
                          int grid, cudaStream_t s) {
  switch (dh) {
    case 16: return launch_mma<KT, 16>(maps, a, consumers, grid, s);
    case 32: return launch_mma<KT, 32>(maps, a, consumers, grid, s);
    case 64: return launch_mma<KT, 64>(maps, a, consumers, grid, s);
    case 128: return launch_mma<KT, 128>(maps, a, consumers, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bf16_mma(int kt, int dh, const CUtensorMap* maps, const MmaArgs& a,
                            int consumers, int grid, cudaStream_t s) {
  switch (kt) {
    case 1: return launch_mma_dh<1>(dh, maps, a, consumers, grid, s);
    case 2: return launch_mma_dh<2>(dh, maps, a, consumers, grid, s);
    case 3: return launch_mma_dh<3>(dh, maps, a, consumers, grid, s);
    case 4: return launch_mma_dh<4>(dh, maps, a, consumers, grid, s);
    case 5: return launch_mma_dh<5>(dh, maps, a, consumers, grid, s);
    case 6: return launch_mma_dh<6>(dh, maps, a, consumers, grid, s);
    case 7: return launch_mma_dh<7>(dh, maps, a, consumers, grid, s);
    case 8: return launch_mma_dh<8>(dh, maps, a, consumers, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace credit

using namespace credit;

// q, k, v: token rows of `in_stride` elements, window w's token i at row
// w*t + i, head h at columns [h*dh, (h+1)*dh). out: rows of `out_stride`.
// bias: (t, t) f32, contiguous. windows = B * nWin. scale = dh^-0.5 as the
// caller rounds it. The plan (cuda_attention.attention_plan):
//   kernel 0, FMA: key_block keys a staged block (nkb = ceil(t / key_block);
//     1 is the exact form), `grid` resident blocks over windows * heads
//     problems;
//   kernel 1, bf16 mma: heads_per_item (64 or 128 columns), windows a pack
//     (t <= 8, else 1), row_tiles (16-row query tiles an item; with one key
//     block, key_block = 16 row_tiles), key_block (64 past one block),
//     consumer warps, slots of each ring, `grid` persistent blocks. Needs
//     in_stride, out_stride multiples of 8 and 16-byte aligned pointers.
extern "C" int credit_window_attention(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, int dtype, int windows,
                                       int heads, int t, int dh, int in_stride, int out_stride,
                                       float scale, int kernel, int heads_per_item, int wpi,
                                       int row_tiles, int key_block, int consumers, int slots,
                                       int grid, void* stream) {
  using namespace credit::attn;
  if (t < 1 || dh < 1 || windows < 1 || heads < 1 || grid < 1 || key_block < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (kernel == 1) {
    if (dtype != kBF16 || heads_per_item < 1 || heads % heads_per_item || key_block % 16 ||
        (heads_per_item * dh) % 64 || slots < 1 || wpi < 1 || row_tiles < 1)
      return (int)cudaErrorInvalidValue;
    const int nkb = (t + key_block - 1) / key_block, qr = 16 * row_tiles;
    const int nq = nkb == 1 ? 1 : (t + qr - 1) / qr;
    const int groups = heads / heads_per_item;
    const MmaArgs a{b, t, wpi, heads_per_item, groups, row_tiles, nq, nkb,
                    (windows + wpi - 1) / wpi * groups * nq, slots, scale};
    // (windows, t, columns) maps; boxes of 64 columns x a pack's t tokens x
    // wpi windows, or of qr (q, out) / key_block (k, v) tokens of a window
    CUtensorMap maps[4];
    const void* bases[4] = {q, k, v, out};
    for (int i = 0; i < 4; ++i) {
      const int stride = i == 3 ? out_stride : in_stride;
      const int rows = wpi > 1 ? t : (i == 1 || i == 2 ? key_block : qr);
      const cuuint64_t dims[3] = {(cuuint64_t)heads * dh, (cuuint64_t)t, (cuuint64_t)windows};
      const cuuint64_t strides[2] = {(cuuint64_t)stride * 2, (cuuint64_t)t * stride * 2};
      const cuuint32_t box[3] = {64, (cuuint32_t)rows, (cuuint32_t)wpi};
      if (!bf16_map(&maps[i], bases[i], 3, dims, strides, box)) return (int)cudaErrorInvalidValue;
    }
    return (int)launch_bf16_mma(key_block / 16, dh, maps, a, consumers, grid, s);
  }
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = fma_smem(t, key_block, dh);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int problems = windows * heads;
  if (dtype == kBF16) {
    auto kern = window_attention_fma<__nv_bfloat16>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), b, static_cast<__nv_bfloat16*>(out), problems,
        heads, t, dh, in_stride, out_stride, scale, key_block);
  } else if (dtype == kF32) {
    auto kern = window_attention_fma<float>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, THREADS, smem, s>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                     static_cast<const float*>(v), b, static_cast<float*>(out),
                                     problems, heads, t, dh, in_stride, out_stride, scale,
                                     key_block);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* credit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
