// One CTA's [sum, count, min, max] partial over one tile of a column,
// shared by filter_agg.cu and block_agg.cu.
//
// Semantics are those of the reference's Pallas bodies
// (repro/kernels/filter_agg.py::_filter_agg_kernel and
// block_agg.py::_block_agg_kernel), all in float32:
//   sum   = sum of where(m, v, 0)
//   count = sum of m
//   min   = min of where(m, v, +3.4e38f)      (3.4e38f, not FLT_MAX)
//   max   = max of where(m, v, -3.4e38f)
// A selected NaN value propagates through sum, min and max, as XLA's
// reductions do; fminf/fmaxf would drop it, so min/max use selects that
// keep a NaN operand.  A row outside [0, n) counts in none of the four.
//
// Layout: the tile is `tile` consecutive elements (8192 by default, the
// reference's 64 x 128 block), one CTA each; the CTA writes one row of
// four floats.  Each thread walks the tile four elements at a time with
// one vector load per column (16 bytes for a 4-byte type, 4 for a
// 1-byte one) when both columns are aligned for it, else one element at
// a time.  Per-thread partials are reduced with __shfl_xor_sync inside
// each warp, then across the warps through shared memory.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace agg {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 3.4e38f;

// dtype codes the launchers take (kernels/filter_agg.py keeps the table)
enum Dtype : int { kF32 = 0, kI32 = 1, kU8 = 2 };

struct Partial {
  float s, c, lo, hi;
};

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ void take(Partial& p, float v, bool m) {
  p.s += m ? v : 0.f;
  p.c += m ? 1.f : 0.f;
  p.lo = min_nan(p.lo, m ? v : kBig);
  p.hi = max_nan(p.hi, m ? v : -kBig);
}

__device__ __forceinline__ void fold(Partial& p, const Partial& q) {
  p.s += q.s;
  p.c += q.c;
  p.lo = min_nan(p.lo, q.lo);
  p.hi = max_nan(p.hi, q.hi);
}

__device__ __forceinline__ Partial shfl_fold(Partial p, int width) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1) {
    Partial q;
    q.s = __shfl_xor_sync(0xffffffffu, p.s, o);
    q.c = __shfl_xor_sync(0xffffffffu, p.c, o);
    q.lo = __shfl_xor_sync(0xffffffffu, p.lo, o);
    q.hi = __shfl_xor_sync(0xffffffffu, p.hi, o);
    fold(p, q);
  }
  return p;
}

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T x[4];
};

template <typename T>
__device__ __forceinline__ Vec4<T> load4(const T* p) {
  return *reinterpret_cast<const Vec4<T>*>(p);
}

inline bool aligned4(const void* p, int elem_bytes) {
  return reinterpret_cast<uintptr_t>(p) % (4u * elem_bytes) == 0;
}

// Src provides  elem(i, v, m)  for element i, and  elem4(i, v, m)  for
// elements i..i+3 by vector loads (only called when `vec` is set).
template <class Src>
__device__ __forceinline__ void tile_partial(const Src& src, long long n,
                                             int tile, bool vec,
                                             float* __restrict__ out) {
  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const long long left = n - start;
  const int len = left < tile ? static_cast<int>(left) : tile;
  Partial p{0.f, 0.f, kBig, -kBig};
  int i = threadIdx.x;
  if (vec) {
    const int len4 = len & ~3;
#pragma unroll 4
    for (int j = 4 * threadIdx.x; j < len4; j += 4 * kThreads) {
      float v[4];
      bool m[4];
      src.elem4(start + j, v, m);
#pragma unroll
      for (int k = 0; k < 4; ++k) take(p, v[k], m[k]);
    }
    i = len4 + threadIdx.x;
  }
  for (; i < len; i += kThreads) {
    float v;
    bool m;
    src.elem(start + i, v, m);
    take(p, v, m);
  }

  p = shfl_fold(p, 32);
  __shared__ Partial warp_part[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_part[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = lane < kWarps ? warp_part[lane] : Partial{0.f, 0.f, kBig, -kBig};
    p = shfl_fold(p, kWarps);
    if (lane == 0) {
      float* row = out + 4 * static_cast<long long>(blockIdx.x);
      row[0] = p.s;
      row[1] = p.c;
      row[2] = p.lo;
      row[3] = p.hi;
    }
  }
}

inline long long n_tiles(long long n, int tile) {
  return (n + tile - 1) / tile;
}

}  // namespace agg
