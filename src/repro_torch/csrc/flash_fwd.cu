// Flash-attention forward for inference on Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The reference computes prefill attention
// with its blockwise online-softmax scan (repro/models/attention.py,
// _flash_fwd_scan), which the port carries as a loop of plain PyTorch
// operators (models/attention.py::_flash_fwd).  On the inference path
// (no gradient wanted, bf16 q/k/v, head widths of 128, heads whole) this
// kernel takes that loop's place, one launch a layer, and computes what
// the loop computes in the same arithmetic: bf16 operands, S = QK^T
// accumulated in float32 and scaled by `scale`, the causal mask
// q_offset + i >= j (none when not causal), the online softmax in
// float32, P rounded to bf16 for the PV product accumulated in float32,
// and the output divided by max(l, 1e-20), written as bf16 in
// (B, Sq, H, 128).  Query head h reads KV head h / G in place.
//
// The loop materialises float32 scores of every 512 x 512 block pair of
// every head in device memory (1.2 GB a pair at 32 x 2,048 with 36
// heads), passes over them about ten times and copies K and V G times.
//
// Bound: the tensor cores.  The causal half of QK^T and PV is
// 4 * B * H * 128 * (Sq * Sk / 2) FLOPs, 1.24e12 at 32 x 2,048 with 36
// heads: 1.25 ms at 989 TFLOP/s.  q, k, v and the output cross device
// memory once, 1.34 GB there: 0.40 ms at 3.35 TB/s.
//
// Design:
//
// * A work tile is 128 query rows of one (batch, head).  They are
//   ordered with the G heads of one KV group next to each other, so a
//   group's K and V are read from device memory once and from L2 by the
//   others, and with the query tiles of the most causal key tiles first,
//   so the short ones even out the end.  The grid is persistent: one CTA
//   an SM walks the work tiles with a stride of the grid, so the next
//   tile's Q and first K and V tiles load while this one finishes.
// * Warp specialisation.  Warpgroup 0 is the producer: it gives up its
//   registers (setmaxnreg 24) and one thread keeps TMA loads of 128-key
//   K and V tiles in flight, kStages deep, each stage guarded by a
//   "full" barrier (the bytes arrived) and an "empty" one (both consumer
//   warpgroups are done with it); Q likewise in two buffers, released
//   after a tile's last S.  Measured against one CTA a work tile, the
//   persistent grid took 5-8% off the call (2.79 against 3.04 ms).
// * Warpgroups 1 and 2 are the consumers (setmaxnreg 240), 64 query rows
//   each.  S = Q K^T is eight wgmma m64n128k16 from shared memory; the
//   mask (only on tiles that cross the diagonal or the end of the keys;
//   tiles past the diagonal are not visited) and the online softmax run
//   on the accumulator in registers; P, rounded to bf16, is the register
//   A operand of eight more wgmma for O += P V, with V read transposed
//   from shared memory.  S and P never reach device or shared memory.
// * Tiles are stored as TMA writes them with the 128-byte swizzle, two
//   64-wide chunks of the head dimension each, which is the layout wgmma
//   reads without bank conflicts: K-major for Q and K, N-major for V.
//
// What is left between it and its bound (H100, one CTA a work tile, 2.9
// ms): with the softmax taken out the call was no faster, with the K and
// V loads taken out about 5% faster, and overlapping each consumer's
// softmax with its own next products (a second S in flight, three
// stages) no faster either.  So the rest sits in how the products are
// fed and in each tile's start and end, not in the exponentials or the
// copies.
//
// The launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (or a negative code where
// a tensor map could not be encoded) so a refused launch reaches the
// wrapper (kernels/flash_fwd.py), which checks shapes, types and
// alignment first.

#include <climits>
#include <cmath>
#include <cstdint>
#include <mutex>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kBlockM = 128;                 // query rows a CTA
constexpr int kBlockN = 128;                 // keys a tile
constexpr int kStages = 2;                   // K and V tiles in flight
constexpr int kConsumers = 2;                // warpgroups of 64 rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kChunk = 64;                   // bf16 in a 128-byte row
constexpr int kTileBytes = kBlockN * kHeadDim * 2;   // a K or V tile
constexpr int kHalfBytes = kTileBytes / 2;           // one 64-wide chunk
constexpr int kQBytes = kBlockM * kHeadDim * 2;
constexpr int kQBuffers = 2;                 // Q tiles: this one and the next
constexpr int kBarBytes = 8 * (2 * kQBuffers + 3 * kStages);
constexpr int kSmemBytes = 1024 + kQBuffers * kQBytes
                           + 2 * kStages * kTileBytes
                           + kBarBytes;      // 1024: room to align
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kBlockM == kBlockN, "Q and K/V chunks share kHalfBytes");

std::once_flag g_smem_once[kMaxDevices];
cudaError_t g_smem_err[kMaxDevices];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// a (64, 1, rows, 1) box of a (B, S, heads, 128) bf16 tensor's map into
// shared memory at `dst`, counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(d), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// a wgmma shared-memory descriptor of the 128-byte swizzle: start address,
// leading and stride byte offsets (all in bytes here, 16-byte units in it)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps registers that an asynchronous wgmma reads or writes where they
// are until the wait that follows it
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, float32) = A (64 x 16, shared, K-major) * B (16 x 128,
// shared, K-major) + (scale_d ? D : 0)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, float32) += A (64 x 16, bf16 in registers) * B (16 x 128,
// shared, N-major: imm-trans-b 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// The work tile of index `wi`: 128 query rows of one (batch, head), the
// longest causal tiles first and the heads of a KV group side by side;
// the key tiles [0, n_tiles) it visits, those from n_free on masked
struct Work {
  int b, h, m0, n_tiles, n_free;
};

__device__ __forceinline__ Work work_tile(int wi, int B, int Sq, int Sk,
                                          int H, int causal, int q_offset) {
  const int n_m = (Sq + kBlockM - 1) / kBlockM;
  const int bh = wi % (B * H);
  Work wk;
  wk.b = bh / H;
  wk.h = bh % H;
  wk.m0 = (n_m - 1 - wi / (B * H)) * kBlockM;
  int key_end = Sk;
  wk.n_free = Sk / kBlockN;
  if (causal) {
    key_end = min(Sk, q_offset + min(Sq, wk.m0 + kBlockM));
    wk.n_free = min(wk.n_free, (q_offset + wk.m0 + 1) / kBlockN);
  }
  wk.n_tiles = (key_end + kBlockN - 1) / kBlockN;
  return wk;
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(__grid_constant__ const CUtensorMap q_map,
                 __grid_constant__ const CUtensorMap k_map,
                 __grid_constant__ const CUtensorMap v_map,
                 __nv_bfloat16* __restrict__ out, int B, int Sq, int Sk,
                 int H, int G, int causal, int q_offset, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on it
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base;                         // + kQBytes * buffer
  const uint32_t s_k = s_q + kQBuffers * kQBytes;
  const uint32_t s_v = s_k + kStages * kTileBytes;
  const uint32_t q_full = s_v + kStages * kTileBytes;   // + 8 * buffer
  const uint32_t q_empty = q_full + 8 * kQBuffers;
  const uint32_t k_full = q_empty + 8 * kQBuffers;       // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;
  const int n_work = ((Sq + kBlockM - 1) / kBlockM) * B * H;

  if (threadIdx.x == 0) {
    for (int q = 0; q < kQBuffers; ++q) {
      mbar_init(q_full + 8 * q, 1);
      mbar_init(q_empty + 8 * q, kConsumers * 4);     // one arrive a warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;                                     // K/V tiles loaded
      int qi = 0;                                     // Q tiles loaded
      for (int wi = blockIdx.x; wi < n_work; wi += gridDim.x, ++qi) {
        const Work wk = work_tile(wi, B, Sq, Sk, H, causal, q_offset);
        const int kvh = wk.h / G;
        const int qb = qi % kQBuffers;
        const uint32_t qbar = q_full + 8 * qb, qdst = s_q + qb * kQBytes;
        mbar_wait(q_empty + 8 * qb, ((qi / kQBuffers) & 1) ^ 1);
        mbar_expect_tx(qbar, kQBytes);
        tma_load(qdst, &q_map, qbar, 0, wk.h, wk.m0, wk.b);
        tma_load(qdst + kHalfBytes, &q_map, qbar, kChunk, wk.h, wk.m0, wk.b);
        for (int i = 0; i < wk.n_tiles; ++i, ++it) {
          const int n = wk.n_tiles - 1 - i;
          const int s = it % kStages;
          mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t kb = s_k + s * kTileBytes, vb = s_v + s * kTileBytes;
          mbar_expect_tx(k_full + 8 * s, kTileBytes);
          tma_load(kb, &k_map, k_full + 8 * s, 0, kvh, n * kBlockN, wk.b);
          tma_load(kb + kHalfBytes, &k_map, k_full + 8 * s, kChunk, kvh,
                   n * kBlockN, wk.b);
          mbar_expect_tx(v_full + 8 * s, kTileBytes);
          tma_load(vb, &v_map, v_full + 8 * s, 0, kvh, n * kBlockN, wk.b);
          tma_load(vb + kHalfBytes, &v_map, v_full + 8 * s, kChunk, kvh,
                   n * kBlockN, wk.b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = wg - 1;                    // rows 64 w .. 64 w + 63
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    int it = 0, qi = 0;
    for (int wi = blockIdx.x; wi < n_work; wi += gridDim.x, ++qi) {
      const Work wk = work_tile(wi, B, Sq, Sk, H, causal, q_offset);
      // this thread's rows of S, P and O: row0 and row0 + 8
      const int row0 = wk.m0 + 64 * w + 16 * warp + g;
      const int pos0 = q_offset + row0, pos1 = pos0 + 8;
      const int qb = qi % kQBuffers;

      float o[64], sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = sc[i] = 0.f;
      float mx0 = -INFINITY, mx1 = -INFINITY, l0 = 0.f, l1 = 0.f;

      mbar_wait(q_full + 8 * qb, (qi / kQBuffers) & 1);
      const uint32_t q_rows = s_q + qb * kQBytes + w * 64 * 128;
      for (int i = 0; i < wk.n_tiles; ++i, ++it) {
        const int n = wk.n_tiles - 1 - i;
        const int s = it % kStages;
        const uint32_t phase = (it / kStages) & 1;

        // S = Q K^T, 64 x 128 float32
        mbar_wait(k_full + 8 * s, phase);
        const uint32_t kb = s_k + s * kTileBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHeadDim / 16; ++kk) {
          const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
          wgmma_ss(sc, make_desc(q_rows + off, 16, 1024),
                   make_desc(kb + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(sc);
        // the last product of this Q tile: its buffer may be refilled
        if (i == wk.n_tiles - 1 && lane == 0) mbar_arrive(q_empty + 8 * qb);
        // element 4j + e: row row0 + 8 (e / 2), key 8j + 2t + e % 2
        if (n >= wk.n_free) {
          const int key0 = n * kBlockN + 2 * t;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = key0 + 8 * j + (e & 1);
              const int pos = (e & 2) ? pos1 : pos0;
              if (key >= Sk || (causal && key > pos)) sc[4 * j + e] = -INFINITY;
            }
          }
        }

        // online softmax; the four threads of a quad share a row
        float new0 = mx0, new1 = mx1;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          new0 = fmaxf(new0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          new1 = fmaxf(new1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int d = 1; d < 4; d *= 2) {
          new0 = fmaxf(new0, __shfl_xor_sync(0xffffffffu, new0, d));
          new1 = fmaxf(new1, __shfl_xor_sync(0xffffffffu, new1, d));
        }
        // a row with no key yet keeps m = -inf and p = 0
        const float ms0 = new0 == -INFINITY ? 0.f : new0 * scale_log2;
        const float ms1 = new1 == -INFINITY ? 0.f : new1 * scale_log2;
        const float corr0 = exp2f(mx0 * scale_log2 - ms0);
        const float corr1 = exp2f(mx1 * scale_log2 - ms1);
        mx0 = new0;
        mx1 = new1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          sc[4 * j] = exp2f(fmaf(sc[4 * j], scale_log2, -ms0));
          sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], scale_log2, -ms0));
          sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], scale_log2, -ms1));
          sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], scale_log2, -ms1));
          sum0 += sc[4 * j] + sc[4 * j + 1];
          sum1 += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l0 = l0 * corr0 + sum0;
        l1 = l1 * corr1 + sum1;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          o[4 * j] *= corr0;
          o[4 * j + 1] *= corr0;
          o[4 * j + 2] *= corr1;
          o[4 * j + 3] *= corr1;
        }
        // P in bf16 as the A fragments of 16 keys each: the accumulator's
        // layout is the operand's
        uint32_t p[kBlockN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          p[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }

        // O += P V: V's 16 keys of a step are two 8-key groups 1024 bytes
        // apart, its two 64-wide chunks kHalfBytes apart
        mbar_wait(v_full + 8 * s, phase);
        const uint32_t vb = s_v + s * kTileBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk)
          wgmma_rs(o, p[kk], make_desc(vb + kk * 2048, kHalfBytes, 1024));
        wgmma_commit();
        wgmma_wait_all();
        pin(o);
        pin(p);
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
      // out = O / max(l, 1e-20) in bf16, (B, Sq, H, 128)
#pragma unroll
      for (int d = 1; d < 4; d *= 2) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, d);
        l1 += __shfl_xor_sync(0xffffffffu, l1, d);
      }
      l0 = fmaxf(l0, 1e-20f);
      l1 = fmaxf(l1, 1e-20f);
      const size_t stride = static_cast<size_t>(H) * kHeadDim;
      __nv_bfloat16* out0 =
          out + (static_cast<size_t>(wk.b) * Sq + row0) * stride
          + static_cast<size_t>(wk.h) * kHeadDim + 2 * t;
      __nv_bfloat16* out1 = out0 + 8 * stride;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (row0 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * j) =
              __floats2bfloat162_rn(o[4 * j] / l0, o[4 * j + 1] / l0);
        if (row0 + 8 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(out1 + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, from the copy PyTorch has loaded: this
// library links against the runtime alone
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(
        dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// the map of a contiguous (B, S, heads, 128) bf16 tensor, read in
// (64, 1, 128, 1) boxes: one 64-wide chunk of 128 rows of one head
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * kHeadDim * 2;
  cuuint64_t dims[4] = {kHeadDim, static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(S),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {kHeadDim * 2, row, row * S};
  cuuint32_t box[4] = {kChunk, 1, kBlockN, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(r);
}

}  // namespace

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, int B, int Sq, int Sk, int H,
                                int K, int causal, int q_offset, float scale,
                                void* stream) {
  if (B <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (Sk <= 0 || H <= 0 || K <= 0 || H % K != 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_work =
      static_cast<long long>((Sq + kBlockM - 1) / kBlockM) * B * H;
  if (n_work > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, n_sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: one CTA an SM walks the work tiles
  const long long grid = n_work < n_sms ? n_work : n_sms;
  std::call_once(g_smem_once[dev], [dev] {
    g_smem_err[dev] = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
  });
  if (g_smem_err[dev] != cudaSuccess)
    return static_cast<int>(g_smem_err[dev]);
  CUtensorMap q_map, k_map, v_map;
  int r = make_map(&q_map, q, B, Sq, H);
  if (r == 0) r = make_map(&k_map, k, B, Sk, K);
  if (r == 0) r = make_map(&v_map, v, B, Sk, K);
  if (r != 0) return r;
  flash_fwd_kernel<<<static_cast<unsigned>(grid), kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), B, Sq, Sk, H,
      H / K, causal, q_offset, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
