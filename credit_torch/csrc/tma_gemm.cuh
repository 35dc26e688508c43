// The warp-specialised TMA + wgmma mainloop of one 128 x BN output tile,
// shared by the VALID conv (conv_valid.cu, a tap is a shift of the A box)
// and the feed-forward's two products (fused_ff.cu, plain row-major GEMMs).
//
// A K step is 64 deep. Its stage holds A, 128 rows of 64 K values (128
// bytes each) landed K-major with 128-byte swizzle by the caller's TMA
// loads, then B, BN / 64 boxes of 64 K rows x 64 N columns landed MN-major
// (N contiguous), read with wgmma's transpose bit. A ring of stages with
// full and empty mbarriers: one producer thread issues each step's loads; two
// consumer warpgroups, rows
// [64 cw, 64 cw + 64) of the tile each, run wgmma.mma_async with one group in
// flight and free a stage once its products are done. The f32 accumulators
// go to the caller's epilogue, which owns the rounding and the stores.
#pragma once

#include "common.cuh"

namespace credit {
namespace tma {

constexpr int KS = 64;        // K values per step (one 128-byte row)
constexpr int A_BYTES = 128 * KS * 2;
constexpr int BOX_BYTES = 64 * KS * 2;  // one 64-column block of B

// CTAS blocks resident on an SM. One block: a producer warpgroup that gives
// its registers to the two consumer warpgroups with setmaxnreg (40 / 232).
// Two blocks, so that one block's epilogue runs beside the other's
// products: each takes half the SM's shared memory (less the 1 KB the SM
// reserves a block) and of its registers; the producer is one warp after
// the consumers (ptxas compiles every warp to the launch bound's 112
// registers, which hold BN = 128's 64 accumulators).
template <int BN, int CTAS = 1>
struct Ring {
  static constexpr int THREADS = CTAS == 1 ? 384 : 288;
  static constexpr int STAGE = A_BYTES + BN * KS * 2;
  static constexpr int BUDGET = CTAS == 1 ? kMaxSmem : kSmSmem / CTAS - 1024;
  static constexpr int STAGES = (BUDGET - 2048) / STAGE < 8 ? (BUDGET - 2048) / STAGE : 8;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
  static_assert(CTAS == 1 || (CTAS == 2 && BN <= 128), "two blocks an SM: BN <= 128");
};

// The tile's mainloop over `steps` K steps. load(it, stage, bar), called for
// it = 0, 1, ... in order, issues step it's TMA loads (Ring::STAGE bytes in
// all: A at stage, B's boxes at stage + A_BYTES + j * BOX_BYTES) completing
// on bar; epilogue(acc, cw) gets consumer warpgroup cw's accumulators.
// Thread t of the warpgroup holds acc[4j + 2h + e] at tile row 64 cw +
// 16 (t / 32 % 4) + t % 32 / 4 + 8h, column 8j + 2 (t % 4) + e. smem_raw:
// Ring<BN, CTAS>::SMEM bytes of dynamic shared memory; every thread of the
// block calls this, in a kernel launched with
// __launch_bounds__(Ring<BN, CTAS>::THREADS, CTAS).
template <int BN, int CTAS = 1, class Load, class Epilogue>
__device__ __forceinline__ void gemm_tile(unsigned char* smem_raw, int steps, Load load,
                                          Epilogue epilogue) {
  using R = Ring<BN, CTAS>;
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int first = CTAS == 1 ? 0 : 256;  // the producer's first thread
  if (CTAS == 1 ? threadIdx.x < 128 : threadIdx.x >= 256) {  // producer
    if constexpr (CTAS == 1) reg_dealloc<40>();
    if (threadIdx.x == first) {
      int s = 0;
      uint32_t ph = 0;
      for (int it = 0; it < steps; ++it) {
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], R::STAGE);
        load(it, smem + s * R::STAGE, &full[s]);
        if (++s == R::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    if constexpr (CTAS == 1) reg_alloc<232>();
    const int cw = threadIdx.x / 128 - (CTAS == 1), lane = threadIdx.x % 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int s = 0, prev = -1;
    uint32_t ph = 0;
    for (int it = 0; it < steps; ++it) {
      mbar_wait(&full[s], ph);
      const uint32_t a0 = smem_u32(smem + s * R::STAGE + cw * 64 * 128);
      const uint32_t b0 = smem_u32(smem + s * R::STAGE + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk)  // A: K-major, 32 bytes a k16 step; B: 16 rows
        Wgmma<BN>::template run<0, 1>(acc, desc_sw128(a0 + kk * 32, 16, 1024),
                                      desc_sw128(b0 + kk * 2048, BOX_BYTES, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == R::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    epilogue(acc, cw);
  }
}

}  // namespace tma
}  // namespace credit
