// Planar bitpack decode for Hopper (sm_90a).
//
// Replaces repro/kernels/bitunpack.py::_bitunpack_kernel, the Pallas TPU
// kernel that decodes the `bitpack<b>` column codec of core/format.py.
//
// Layout: each group of 32 values is `bits` uint32 words; word k holds
// bit k of all 32 values.  Value j of a group is therefore bit j of every
// word, gathered into one integer: a 32x32 bit-matrix transpose.  The
// TPU kernel's (R, 4, bits) -> (R, 128) row tiling existed for the
// 128-lane VPU and is not carried over.
//
// Bound: memory traffic, n*bits/8 bytes read plus 4n bytes written, at
// the H100's 3.35 TB/s (0.4908 ms for 2^28 values of bitpack17).  At that
// rate an SM has about 13.5 cycles per 32-value group of bitpack17, so a
// group may cost about 54 warp-instructions spread over the ALU and FMA
// pipes, and 13 on the shuffle unit (one warp-shuffle per cycle per SM).
//
// Design, and what each part is for:
//
// * Staged tiles.  A CTA's input is one contiguous span of tile*bits
//   words (`tile` groups; the wrapper picks 32..256 from the column's
//   size so that small columns still spread over every SM, and sizes a
//   persistent grid for large ones).  The CTA walks its tiles with a
//   stride of gridDim.x and keeps kStages = 3 tiles in shared memory: the
//   copies of the next two are in flight (16-byte `cp.async`) while this
//   one is transposed.  At bitpack17 and tile 256 a stage is 17 KB and
//   four CTAs fit on an SM, about 140 KB of loads in flight per SM (the
//   latency of HBM needs about 2.3 MB across the card).  The first design
//   (one ballot-transpose warp per group, loads straight from global) had
//   about 0.6 MB in flight and reached 16% of the bound.
//
// * Alignment.  The words may start at any 4-byte offset (a view such as
//   packed[1:]).  Word q of a tile lands at buf[ph + q], ph being the
//   tile start's word offset within its 16-byte line, so aligned global
//   lines meet aligned shared lines: the aligned body goes by 16-byte
//   copies and the at most three words before and after it by 4-byte
//   copies, all inside the kernel.  A stage holds tile*bits + 4 words.
//
// * Transpose: a five-stage butterfly through `__shfl_xor_sync`.  Lane k
//   holds word k (zero for k >= bits); stage w (16, 8, 4, 2, 1) swaps the
//   off-diagonal w x w blocks of every 2w x 2w block of the bit matrix:
//   each lane rotates its word by w one way or the other (one funnel
//   shift, the amount fixed per lane), trades it with lane ^ w, and keeps
//   half of each with one three-input logic op.  After five stages lane j
//   holds value j.  That is 15 instructions per group whatever the width
//   (10 on the ALU, 5 shuffles; nvcc's SASS has 69 from the first of a
//   trip's 20 shuffles to the last, about 17 per group), against 32
//   ballots and about 130 instructions in the first design, and against
//   about 3*bits for the other way considered, lane j gathering bit j of
//   each word from shared memory with a shift and an insert (cheaper
//   only below 6 bits; the scan's columns are bitpack7 and the ingest's
//   bitpack17).  Chosen by that count; measured, the kernel with the
//   butterfly taken out is only about 2% faster, so the transpose is not
//   what is left between the kernel and its bound.
//
//   Each warp runs four groups per trip for independent work, reads each
//   group's words from shared memory in one conflict-free access, and
//   writes each group as one coalesced 128-byte store, lane j -> value j.
//   Values past the tile's groups or past n are not stored; every lane
//   takes every trip, so the full-mask shuffles are legal.
//
// The launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so a refused launch is
// reported to the wrapper.  The geometry (tile, grid, shared memory) comes
// from the wrapper (kernels/bitunpack.py::launch_plan), which the CPU
// tests check; the launcher refuses a plan whose shared memory does not
// match its stages.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                  // groups per warp per trip
constexpr int kStages = 3;
constexpr int kMinTile = 32;
constexpr int kMaxTile = 256;
constexpr int kMaxSmem = kStages * (kMaxTile * 32 + 4) * 4;   // 98,352 B
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// v, opaque to the compiler: a per-lane constant stays in its register
// instead of being recomputed (and its mask folded into two extra logic
// ops) at every use in the loop
__device__ __forceinline__ uint32_t pinned(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// the word offset of p within its 16-byte line
__device__ __forceinline__ int line_phase(const uint32_t* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3u);
}

// Issue the copies of `len` words at src into buf[ph ..  ph + len).
__device__ __forceinline__ void stage_tile(uint32_t* buf, const uint32_t* src,
                                           int len) {
  const int ph = line_phase(src);
  const int head = min((4 - ph) & 3, len);
  const int nvec = (len - head) >> 2;
  const int tail = len - head - 4 * nvec;
  uint32_t* dst = buf + ph;
  for (int c = threadIdx.x; c < nvec; c += kThreads)
    cp_async16(dst + head + 4 * c, src + head + 4 * c);
  const int t = threadIdx.x;
  if (t < head) cp_async4(dst + t, src + t);
  const int u = kThreads - 1 - t;           // the tail goes to the last threads
  if (u < tail) {
    const int q = head + 4 * nvec + u;
    cp_async4(dst + q, src + q);
  }
}

__global__ void __launch_bounds__(kThreads, 4)
bitunpack_kernel(const uint32_t* __restrict__ words,
                 uint32_t* __restrict__ out,
                 long long n_groups, int bits, long long n, int tile) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int stride = tile * bits + 4;
  const long long n_tiles = (n_groups + tile - 1) / tile;
  const long long span = static_cast<long long>(tile) * bits;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // per lane and butterfly stage: the rotation (left by w for the upper
  // lane of a pair, right by w for the lower) and the bits it keeps
  uint32_t rot[5], keep[5];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int w = 16 >> s;
    // the bits b with (b & w) == 0: 0x0000ffff, 0x00ff00ff, ... 0x55555555
    const uint32_t low = 0xffffffffu / ((1u << w) + 1u);
    const bool upper = lane & w;
    rot[s] = pinned(upper ? w : 32 - w);
    keep[s] = pinned(upper ? ~low : low);
  }
  // lanes past the last word read the group's last word, then drop it
  const uint32_t word_mask = pinned(lane < bits ? 0xffffffffu : 0u);
  const int word = lane < bits ? lane : bits - 1;

  auto groups_of = [&](long long t) -> int {
    const long long left = n_groups - t * tile;
    return left < tile ? static_cast<int>(left) : tile;
  };

  // prologue: the first kStages - 1 tiles in flight (one commit group
  // each, empty past the end, so the wait below counts groups alike)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const long long t = blockIdx.x + static_cast<long long>(s) * gridDim.x;
    if (t < n_tiles) stage_tile(smem + s * stride, words + t * span,
                                groups_of(t) * bits);
    cp_async_commit();
  }

  int slot = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    // the slot this fills was read in the previous trip, which ended in
    // __syncthreads()
    const long long ahead =
        t + static_cast<long long>(kStages - 1) * gridDim.x;
    const int ahead_slot = slot == 0 ? kStages - 1 : slot - 1;
    if (ahead < n_tiles) stage_tile(smem + ahead_slot * stride,
                                    words + ahead * span,
                                    groups_of(ahead) * bits);
    cp_async_commit();
    cp_async_wait<kStages - 1>();           // this thread's copies of tile t
    __syncthreads();                        // ... and every thread's

    const uint32_t* row =
        smem + slot * stride + line_phase(words + t * span) + word;
    const int groups = groups_of(t);
    uint32_t* dst = out + t * tile * 32LL;
    // values of this tile to store: its groups, and no further than n
    const long long left = n - t * tile * 32LL;
    const int lim = left < groups * 32 ? static_cast<int>(left) : groups * 32;
    for (int g0 = 0; g0 < groups; g0 += kWarps * kUnroll) {
      // a group past the tile's last (g >= groups) reads words of the
      // stage that are not its own; they stay in that group's lanes, and
      // its values are not stored
      uint32_t x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        x[u] = row[(g0 + warp + kWarps * u) * bits] & word_mask;
#pragma unroll
      for (int s = 0; s < 5; ++s) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const uint32_t send = __funnelshift_l(x[u], x[u], rot[s]);
          const uint32_t y = __shfl_xor_sync(kFull, send, 16 >> s);
          x[u] = (x[u] & keep[s]) | (y & ~keep[s]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = (g0 + warp + kWarps * u) * 32 + lane;
        if (i < lim) dst[i] = x[u];
      }
    }
    __syncthreads();
    slot = slot == kStages - 1 ? 0 : slot + 1;
  }
}

std::once_flag g_smem_once[kMaxDevices];
cudaError_t g_smem_err[kMaxDevices];

}  // namespace

extern "C" int bitunpack_launch(const void* words, void* out,
                                long long n_groups, int bits, long long n,
                                int tile, int grid, int smem_bytes,
                                void* stream) {
  if (n_groups <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (bits < 1 || bits > 32 || tile < kMinTile || tile > kMaxTile ||
      tile % 32 != 0 || grid < 1 || n > n_groups * 32 ||
      smem_bytes != kStages * (tile * bits + 4) * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  // above 48 KB only after this attribute is raised: once per device,
  // and scans launch from the store's pool threads
  std::call_once(g_smem_once[dev], [dev] {
    g_smem_err[dev] = cudaFuncSetAttribute(
        bitunpack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
  });
  if (g_smem_err[dev] != cudaSuccess)
    return static_cast<int>(g_smem_err[dev]);
  bitunpack_kernel<<<static_cast<unsigned>(grid), kThreads, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out),
      n_groups, bits, n, tile);
  return static_cast<int>(cudaGetLastError());
}
