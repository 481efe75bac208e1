// Planar bitpack decode for Hopper (sm_90a).
//
// Replaces repro/kernels/bitunpack.py::_bitunpack_kernel, the Pallas TPU
// kernel that decodes the `bitpack<b>` column codec of core/format.py.
//
// Layout: each group of 32 values is `bits` uint32 words; word k holds
// bit k of all 32 values.  Value j of a group is therefore bit j of every
// word, gathered into one integer: a 32x32 bit-matrix transpose.
//
// Design: one warp per group.  Lane k < bits loads word k (lanes >= bits
// hold 0), and for j = 0..31 `__ballot_sync` of bit j across the warp IS
// value j (bit k of the ballot comes from lane k, i.e. from word k).
// Lane j keeps ballot j, so the warp stores 32 consecutive values: 128
// contiguous bytes.  Blocks of 8 warps walk the groups with a
// grid-stride loop.  The TPU kernel's (R, 4, bits) -> (R, 128) row
// tiling existed for the 128-lane VPU and is not carried over.
//
// Bound: memory traffic, n*bits/8 bytes read plus 4n bytes written,
// against the H100's 3.35 TB/s.  The 32 ballots per group cost about as
// many issue slots as the bytes take to move; a shuffle-based 5-stage
// transpose would cut them, and is left for a later change.
//
// The launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so a refused launch is
// reported to the wrapper.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBlocks = 132 * 32;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bitunpack_kernel(const uint32_t* __restrict__ words,
                 uint32_t* __restrict__ out,
                 long long n_groups, int bits, long long n) {
  const int lane = threadIdx.x & 31;
  const long long first_warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  // g is the same on every lane of a warp, so the whole warp takes each
  // trip of this loop together and the full-mask ballots are legal
  for (long long g = first_warp; g < n_groups; g += n_warps) {
    const uint32_t w = lane < bits ? __ldg(words + g * bits + lane) : 0u;
    uint32_t mine = 0u;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t v = __ballot_sync(0xffffffffu, (w >> j) & 1u);
      if (lane == j) mine = v;
    }
    const long long i = g * 32 + lane;
    if (i < n) out[i] = mine;
  }
}

}  // namespace

extern "C" int bitunpack_launch(const void* words, void* out,
                                long long n_groups, int bits, long long n,
                                void* stream) {
  if (n_groups <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  long long blocks = (n_groups + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bitunpack_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out),
      n_groups, bits, n);
  return static_cast<int>(cudaGetLastError());
}
