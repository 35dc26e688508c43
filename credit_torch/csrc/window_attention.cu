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
// bf16 with dh = 16, 32 or 64 runs both products on the tensor cores
// (mma.sync m16n8k16), FlashAttention-2 style: one warp owns a (window,
// head) problem and stages its q (scaled), k and v in its own shared memory
// (~27 KB at T = 100), so warps never wait on each other. Per 16-row query
// tile the scores stay in registers (T padded to a multiple of 16, padded
// keys masked), the bias is added from L1 (the same padded (T, T) f32 table
// serves every problem), the softmax runs on the registers with quad
// shuffles, and P, rounded to bf16, is re-packed in registers as the A
// operand of P . V. f32 (and other head widths) take plain FMA: a block
// stages the bias once and loops over problems, one warp per query row.
// The TPU kernel's block-diagonal window grouping, which exists only to
// give the MXU 128-wide shapes, has no counterpart here.
#include <cmath>

#include "common.cuh"

namespace credit {
namespace attn {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_T = 128;
constexpr int MAX_DH = 64;

__host__ __device__ inline int ldk(int dh) { return dh + 1; }
__host__ __device__ inline int pad16(int t) { return (t + 15) / 16 * 16; }

__host__ inline size_t smem_bytes(int t, int dh) {
  return ((size_t)t * t + 3 * (size_t)t * ldk(dh) + (size_t)WARPS * MAX_T) * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
window_attention_fma(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias, int ldb,
                     T* __restrict__ out, int problems, int heads, int t, int dh,
                     int in_stride, int out_stride, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* sb = sm;                  // (t, t) bias
  float* sq = sb + t * t;          // (t, dh+1) scaled q
  float* sk = sq + t * ldk(dh);    // (t, dh+1)
  float* sv = sk + t * ldk(dh);    // (t, dh+1)
  float* sp = sv + t * ldk(dh);    // (WARPS, MAX_T) probabilities
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T scale_t = from_f32<T>(scale);

  for (int i = threadIdx.x; i < t * t; i += THREADS) sb[i] = bias[(i / t) * ldb + i % t];

  for (int pr = blockIdx.x; pr < problems; pr += gridDim.x) {
    const int win = pr / heads, h = pr % heads;
    __syncthreads();  // the previous problem is done with q, k, v
    for (int e = threadIdx.x; e < t * dh; e += THREADS) {
      const int row = e / dh, d = e % dh;
      const size_t at = ((size_t)win * t + row) * in_stride + (size_t)h * dh + d;
      // q * scale rounded to q's dtype, then widened
      sq[row * ldk(dh) + d] = to_f32(from_f32<T>(to_f32(q[at]) * to_f32(scale_t)));
      sk[row * ldk(dh) + d] = to_f32(k[at]);
      sv[row * ldk(dh) + d] = to_f32(v[at]);
    }
    __syncthreads();
    float* prow = sp + warp * MAX_T;
    for (int i = warp; i < t; i += WARPS) {
      float s[MAX_T / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < MAX_T / 32; ++jj) {
        const int j = lane + 32 * jj;
        s[jj] = -INFINITY;
        if (j < t) {
          float acc = 0.f;
          for (int d = 0; d < dh; ++d) acc = fmaf(sq[i * ldk(dh) + d], sk[j * ldk(dh) + d], acc);
          s[jj] = acc + sb[i * t + j];
          mx = fmaxf(mx, s[jj]);
        }
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < MAX_T / 32; ++jj) {
        const int j = lane + 32 * jj;
        s[jj] = j < t ? expf(s[jj] - mx) : 0.f;
        sum += s[jj];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int jj = 0; jj < MAX_T / 32; ++jj) {
        const int j = lane + 32 * jj;
        // p rounded to v's dtype before the P.V product
        if (j < t) prow[j] = to_f32(from_f32<T>(s[jj] / sum));
      }
      __syncwarp();
      for (int d = lane; d < dh; d += 32) {
        float acc = 0.f;
        for (int j = 0; j < t; ++j) acc = fmaf(prow[j], sv[j * ldk(dh) + d], acc);
        out[((size_t)win * t + i) * out_stride + (size_t)h * dh + d] = from_f32<T>(acc);
      }
      __syncwarp();  // prow is rewritten by this warp's next row
    }
  }
}

// ------------------------------------------------------------- bf16, mma
// One warp per (window, head) problem: it stages q (scaled), k and v in its
// own shared memory, then for each 16-row query tile computes the scores in
// registers, the softmax there, and P.V from the same registers. KT = 16-key
// tiles (T padded to TP = 16 KT), DH = head width.
constexpr int ATTN_WARPS = 4;  // per block

__host__ __device__ inline int ldqkv(int dh) { return dh + 8; }  // 16 bytes of skew

__host__ inline size_t smem_mma(int tp, int dh) {
  return (size_t)ATTN_WARPS * 3 * tp * ldqkv(dh) * sizeof(__nv_bfloat16);
}

// One call's operands (see credit_window_attention).
struct Args {
  const __nv_bfloat16 *q, *k, *v;
  const float* bias;  // (16 KT, 16 KT) f32, zero beyond t
  __nv_bfloat16* out;
  int problems, heads, t, in_stride, out_stride;
  float scale;
};

// q, k, v rows and out rows 16-byte aligned
template <int KT, int DH>
__global__ void __launch_bounds__(ATTN_WARPS * 32) window_attention_mma(const Args a) {
  constexpr int TP = 16 * KT, LD = DH + 8, VECS = DH / 8;
  const __nv_bfloat16* __restrict__ q = a.q;
  const __nv_bfloat16* __restrict__ k = a.k;
  const __nv_bfloat16* __restrict__ v = a.v;
  const float* __restrict__ bias = a.bias;
  __nv_bfloat16* __restrict__ out = a.out;
  const int heads = a.heads, t = a.t, in_stride = a.in_stride, out_stride = a.out_stride;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;  // the thread's row and column pair in an mma tile
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem) + warp * 3 * TP * LD;
  __nv_bfloat16* sk = sq + TP * LD;
  __nv_bfloat16* sv = sk + TP * LD;
  const float scale_bf = __bfloat162float(__float2bfloat16(a.scale));

  for (int pr = blockIdx.x * ATTN_WARPS + warp; pr < a.problems; pr += gridDim.x * ATTN_WARPS) {
    const int win = pr / heads, h = pr % heads;
    __syncwarp();  // the previous problem is done with this warp's tiles
    for (int e = lane; e < TP * VECS; e += 32) {
      const int row = e / VECS, d = (e % VECS) * 8;
      uint4 qv = make_uint4(0, 0, 0, 0), kv = qv, vv = qv;
      if (row < t) {
        const size_t at = ((size_t)win * t + row) * in_stride + (size_t)h * DH + d;
        qv = *reinterpret_cast<const uint4*>(q + at);
        kv = *reinterpret_cast<const uint4*>(k + at);
        vv = *reinterpret_cast<const uint4*>(v + at);
        __nv_bfloat16* qe = reinterpret_cast<__nv_bfloat16*>(&qv);
#pragma unroll
        for (int i = 0; i < 8; ++i)  // q * scale rounded to bf16, as the TPU kernel
          qe[i] = __float2bfloat16(__bfloat162float(qe[i]) * scale_bf);
      }
      *reinterpret_cast<uint4*>(sq + row * LD + d) = qv;
      *reinterpret_cast<uint4*>(sk + row * LD + d) = kv;
      *reinterpret_cast<uint4*>(sv + row * LD + d) = vv;
    }
    __syncwarp();

    for (int rt = 0; rt < KT; ++rt) {
      if (rt * 16 >= t) break;
      uint32_t qa[DH / 16][4];
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd)
        ldmatrix_x4(qa[kd], sq + (rt * 16 + lane % 16) * LD + kd * 16 + (lane / 16) * 8);
      // S = bias + Q K^T: n8 tile j covers keys 8j..8j+7
      float s[2 * KT][4];
      const int r = rt * 16 + g;
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
        const float2 lo = *reinterpret_cast<const float2*>(bias + r * TP + j * 8 + 2 * qd);
        const float2 hi = *reinterpret_cast<const float2*>(bias + (r + 8) * TP + j * 8 + 2 * qd);
        s[j][0] = lo.x, s[j][1] = lo.y, s[j][2] = hi.x, s[j][3] = hi.y;
      }
#pragma unroll
      for (int kp = 0; kp < KT; ++kp)
#pragma unroll
        for (int kd = 0; kd < DH / 16; ++kd) {
          uint32_t kb[4];  // K rows are B's columns: the plain (untransposed) load
          ldmatrix_x4(kb, sk + (kp * 16 + lane % 8 + (lane / 16) * 8) * LD + kd * 16 +
                              ((lane / 8) % 2) * 8);
          mma_bf16(s[2 * kp], qa[kd], kb[0], kb[1]);
          mma_bf16(s[2 * kp + 1], qa[kd], kb[2], kb[3]);
        }
      // softmax over keys < t in f32, exact division; a row's values sit in
      // the 4 threads of a quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j * 8 + 2 * qd + (e & 1) >= t) s[j][e] = -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      }
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - mx[e / 2]);  // exp(-inf) = 0 for masked keys
          sum[e / 2] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      }
      // O = P V: the score tiles 2kp, 2kp+1 are the A operand of key block kp
      float o[DH / 8][4];
#pragma unroll
      for (int d = 0; d < DH / 8; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < KT; ++kp) {
        uint32_t pa[4];  // p rounded to bf16 before the product
        pa[0] = pack_bf16(s[2 * kp][0] / sum[0], s[2 * kp][1] / sum[0]);
        pa[1] = pack_bf16(s[2 * kp][2] / sum[1], s[2 * kp][3] / sum[1]);
        pa[2] = pack_bf16(s[2 * kp + 1][0] / sum[0], s[2 * kp + 1][1] / sum[0]);
        pa[3] = pack_bf16(s[2 * kp + 1][2] / sum[1], s[2 * kp + 1][3] / sum[1]);
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, sv + (kp * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                                    (lane / 16) * 8);
          mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
#pragma unroll
      for (int d = 0; d < DH / 8; ++d)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r + 8 * i;
          if (row < t)
            *reinterpret_cast<uint32_t*>(out + ((size_t)win * t + row) * out_stride +
                                         (size_t)h * DH + d * 8 + 2 * qd) =
                pack_bf16(o[d][2 * i], o[d][2 * i + 1]);
        }
    }
  }
}

template <int KT, int DH>
void launch_mma(const Args& a, int sms, cudaStream_t s) {
  auto kern = window_attention_mma<KT, DH>;
  const size_t smem = smem_mma(16 * KT, DH);
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, ATTN_WARPS * 32, smem);
  const int want = (a.problems + ATTN_WARPS - 1) / ATTN_WARPS;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);  // the warps loop over problems
  kern<<<want < resident ? want : resident, ATTN_WARPS * 32, smem, s>>>(a);
}

// The bf16 kernel for T padded to 16 kt keys and head width dh; false if
// there is none (dh not 16, 32 or 64, or kt > 8).
template <int KT>
bool launch_mma_dh(int dh, const Args& a, int sms, cudaStream_t s) {
  switch (dh) {
    case 16: launch_mma<KT, 16>(a, sms, s); return true;
    case 32: launch_mma<KT, 32>(a, sms, s); return true;
    case 64: launch_mma<KT, 64>(a, sms, s); return true;
    default: return false;
  }
}

bool launch_bf16_mma(int kt, int dh, const Args& a, int sms, cudaStream_t s) {
  switch (kt) {
    case 1: return launch_mma_dh<1>(dh, a, sms, s);
    case 2: return launch_mma_dh<2>(dh, a, sms, s);
    case 3: return launch_mma_dh<3>(dh, a, sms, s);
    case 4: return launch_mma_dh<4>(dh, a, sms, s);
    case 5: return launch_mma_dh<5>(dh, a, sms, s);
    case 6: return launch_mma_dh<6>(dh, a, sms, s);
    case 7: return launch_mma_dh<7>(dh, a, sms, s);
    case 8: return launch_mma_dh<8>(dh, a, sms, s);
    default: return false;
  }
}

}  // namespace attn
}  // namespace credit

using namespace credit;

// q, k, v: token rows of `in_stride` elements, window w's token i at row
// w*t + i, head h at columns [h*dh, (h+1)*dh). out: rows of `out_stride`.
// bias: f32, row stride pad16(t), zero beyond t. windows = B * nWin.
// scale = dh^-0.5 as the caller rounds it.
extern "C" int credit_window_attention(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, int dtype, int windows,
                                       int heads, int t, int dh, int in_stride, int out_stride,
                                       float scale, void* stream) {
  using namespace credit::attn;
  if (t < 1 || t > MAX_T || dh < 1 || dh > MAX_DH || windows < 1 || heads < 1)
    return (int)cudaErrorInvalidValue;
  const int problems = windows * heads;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int blocks = problems < 8 * sms ? problems : 8 * sms;  // the f32 blocks loop
  const int ldb = pad16(t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
                        16) == 0;
  const Args args{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
                  static_cast<__nv_bfloat16*>(out), problems, heads, t, in_stride, out_stride,
                  scale};
  if (dtype == kBF16 && aligned && in_stride % 8 == 0 && out_stride % 8 == 0 &&
      launch_bf16_mma(ldb / 16, dh, args, sms, s)) {
    // launched on the tensor cores
  } else if (dtype == kBF16) {
    const size_t smem = smem_bytes(t, dh);
    auto kern = window_attention_fma<__nv_bfloat16>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<blocks, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias), ldb,
        static_cast<__nv_bfloat16*>(out), problems, heads, t, dh, in_stride, out_stride, scale);
  } else if (dtype == kF32) {
    const size_t smem = smem_bytes(t, dh);
    auto kern = window_attention_fma<float>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<blocks, THREADS, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), ldb, static_cast<float*>(out), problems, heads, t, dh,
        in_stride, out_stride, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* credit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
