// Identity copy of a contiguous array.
//
// Replaces tools/bench_conv_ffk.py `pallas_identity` (the pallas_call at
// :75): a probe that copied the stage-0 embed conv's (1, 400, 720, 128)
// bf16 output, 73.7 MB, through VMEM in blocks of 8 rows. In the port it is
// the memory-copy yardstick of credit_torch/tools/bench_conv_ffk.py.
//
// Bound on the H100: bytes (each byte read once and written once: 2 x 73.7
// MB over 3.35 TB/s = 0.044 ms). Design: a grid over blocks of rows of
// 16-byte vectors, 32 KB a block (256 threads x 8 vectors); each thread
// issues its 8 loads before its 8 stores so that enough bytes are in
// flight, and the last block masks the ragged end.
#include "common.cuh"

namespace credit {
namespace copy {

constexpr int THREADS = 256;
constexpr int VPT = 8;  // 16-byte vectors per thread

__global__ void __launch_bounds__(THREADS)
copy16(const uint4* __restrict__ src, uint4* __restrict__ dst, size_t n16) {
  const size_t base = (size_t)blockIdx.x * THREADS * VPT + threadIdx.x;
  uint4 v[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const size_t k = base + (size_t)i * THREADS;
    if (k < n16) v[i] = src[k];
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const size_t k = base + (size_t)i * THREADS;
    if (k < n16) dst[k] = v[i];
  }
}

}  // namespace copy
}  // namespace credit

// dst[0:nbytes] = src[0:nbytes]; both 16-byte aligned, nbytes % 16 == 0.
extern "C" int credit_copy(const void* src, void* dst, long long nbytes, void* stream) {
  using namespace credit::copy;
  if (nbytes < 0 || nbytes % 16) return (int)cudaErrorInvalidValue;
  const size_t n16 = (size_t)nbytes / 16;
  if (n16 == 0) return (int)cudaSuccess;
  const size_t blocks = (n16 + THREADS * VPT - 1) / (THREADS * VPT);
  copy16<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n16);
  return (int)cudaGetLastError();
}
