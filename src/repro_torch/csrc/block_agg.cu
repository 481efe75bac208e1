// Masked per-tile partial aggregation for Hopper (sm_90a).
//
// Replaces repro/kernels/block_agg.py::block_agg (body _block_agg_kernel),
// the Pallas TPU kernel behind ops.masked_aggregate: per tile of values,
// the float32 partial [sum, count, min, max] over the rows whose mask is
// nonzero (semantics in agg_tile.cuh).  The output is (n_tiles, 4)
// float32, one row per CTA.
//
// Templated on the value type (float32, int32; cast to float32 in
// registers as the TPU body's astype did) and on the mask type (int32,
// or one byte for bool and uint8: the TPU wrapper widened every mask to
// int32 first, here a bool mask is read as it lies, a quarter of the
// bytes).
//
// Bound: memory traffic, each input read once and 16 bytes per tile
// written, against the H100's 3.35 TB/s.  Same loop and reduction as
// filter_agg (agg_tile.cuh).
//
// The launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include "agg_tile.cuh"

namespace {

template <typename V, typename M>
struct MaskSrc {
  const V* v;
  const M* m;

  __device__ __forceinline__ void elem(long long i, float& vo,
                                       bool& mo) const {
    vo = static_cast<float>(v[i]);
    mo = m[i] != M(0);
  }

  __device__ __forceinline__ void elem4(long long i, float (&vo)[4],
                                        bool (&mo)[4]) const {
    const agg::Vec4<V> a = agg::load4(v + i);
    const agg::Vec4<M> b = agg::load4(m + i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      vo[k] = static_cast<float>(a.x[k]);
      mo[k] = b.x[k] != M(0);
    }
  }
};

template <typename V, typename M>
__global__ void __launch_bounds__(agg::kThreads)
block_agg_kernel(const V* __restrict__ v, const M* __restrict__ m,
                 long long n, int tile, bool vec, float* __restrict__ out) {
  agg::tile_partial(MaskSrc<V, M>{v, m}, n, tile, vec, out);
}

template <typename V, typename M>
int launch(const void* v, const void* m, long long n, int tile, void* out,
           cudaStream_t stream) {
  const bool vec = tile % 4 == 0 && agg::aligned4(v, sizeof(V)) &&
                   agg::aligned4(m, sizeof(M));
  block_agg_kernel<V, M>
      <<<static_cast<unsigned>(agg::n_tiles(n, tile)), agg::kThreads, 0,
         stream>>>(static_cast<const V*>(v), static_cast<const M*>(m), n,
                   tile, vec, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_m(int m_dtype, const void* v, const void* m, long long n,
             int tile, void* out, cudaStream_t s) {
  switch (m_dtype) {
    case agg::kI32: return launch<V, int32_t>(v, m, n, tile, out, s);
    case agg::kU8: return launch<V, uint8_t>(v, m, n, tile, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// values: n elements of v_dtype (0 float32, 1 int32); mask: n elements
// of m_dtype (1 int32, 2 one byte: bool or uint8); out: ceil(n / tile)
// x 4 float32.
extern "C" int block_agg_launch(const void* values, int v_dtype,
                                const void* mask, int m_dtype, long long n,
                                int tile, void* out, void* stream) {
  if (tile <= 0 || n < 0 || agg::n_tiles(n, tile) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v_dtype) {
    case agg::kF32: return launch_m<float>(m_dtype, values, mask, n, tile, out, s);
    case agg::kI32:
      return launch_m<int32_t>(m_dtype, values, mask, n, tile, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
