// Fused predicate filter + per-tile partial aggregation for Hopper (sm_90a).
//
// Replaces repro/kernels/filter_agg.py::filter_agg (body
// _filter_agg_kernel), the Pallas TPU kernel behind ops.filter_aggregate
// and the device pushdown: per tile of values, m = f32(filter) cmp
// f32(thr) with cmp fixed at compile time, and the float32 partial
// [sum where(m, v, 0), count m, min, max] (semantics in agg_tile.cuh).
//
// The TPU kernel's (n_tiles, 4, 128) lane-replicated output was a VPU
// layout artefact: here each CTA writes one (4,) row, so the partials
// are (n_tiles, 4) float32.
//
// The comparator and both column types are template parameters (six
// comparators x {float32, int32} values x {float32, int32} filter); the
// launcher picks the instantiation.  Both columns are cast to float32
// in registers, as the TPU body's astype(float32) did, so the caller
// pays no separate cast pass over the column.  The threshold arrives
// as a float: a double threshold would promote the compare and change
// the answer next to it.
//
// Bound: memory traffic, each input column read once and 16 bytes per
// tile written, against the H100's 3.35 TB/s.  Nothing is reused, so
// the design's job is to keep loads in flight: vector loads, a loop the
// compiler unrolls, and 32 CTAs of a 2^28-row column per SM.
//
// The launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include "agg_tile.cuh"

namespace {

template <typename V, typename F, int OP>
struct FilterSrc {
  const V* v;
  const F* f;
  float thr;

  __device__ __forceinline__ bool pred(float x) const {
    if constexpr (OP == 0) return x < thr;
    if constexpr (OP == 1) return x <= thr;
    if constexpr (OP == 2) return x > thr;
    if constexpr (OP == 3) return x >= thr;
    if constexpr (OP == 4) return x == thr;
    return x != thr;
  }

  __device__ __forceinline__ void elem(long long i, float& vo,
                                       bool& mo) const {
    vo = static_cast<float>(v[i]);
    mo = pred(static_cast<float>(f[i]));
  }

  __device__ __forceinline__ void elem4(long long i, float (&vo)[4],
                                        bool (&mo)[4]) const {
    const agg::Vec4<V> a = agg::load4(v + i);
    const agg::Vec4<F> b = agg::load4(f + i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      vo[k] = static_cast<float>(a.x[k]);
      mo[k] = pred(static_cast<float>(b.x[k]));
    }
  }
};

template <typename V, typename F, int OP>
__global__ void __launch_bounds__(agg::kThreads)
filter_agg_kernel(const V* __restrict__ v, const F* __restrict__ f,
                  long long n, int tile, float thr, bool vec,
                  float* __restrict__ out) {
  agg::tile_partial(FilterSrc<V, F, OP>{v, f, thr}, n, tile, vec, out);
}

template <typename V, typename F, int OP>
int launch(const void* v, const void* f, long long n, int tile, float thr,
           void* out, cudaStream_t stream) {
  const bool vec = tile % 4 == 0 && agg::aligned4(v, sizeof(V)) &&
                   agg::aligned4(f, sizeof(F));
  filter_agg_kernel<V, F, OP>
      <<<static_cast<unsigned>(agg::n_tiles(n, tile)), agg::kThreads, 0,
         stream>>>(static_cast<const V*>(v), static_cast<const F*>(f), n,
                   tile, thr, vec, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename F>
int launch_op(int op, const void* v, const void* f, long long n, int tile,
              float thr, void* out, cudaStream_t s) {
  switch (op) {
    case 0: return launch<V, F, 0>(v, f, n, tile, thr, out, s);
    case 1: return launch<V, F, 1>(v, f, n, tile, thr, out, s);
    case 2: return launch<V, F, 2>(v, f, n, tile, thr, out, s);
    case 3: return launch<V, F, 3>(v, f, n, tile, thr, out, s);
    case 4: return launch<V, F, 4>(v, f, n, tile, thr, out, s);
    case 5: return launch<V, F, 5>(v, f, n, tile, thr, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename V>
int launch_f(int f_dtype, int op, const void* v, const void* f, long long n,
             int tile, float thr, void* out, cudaStream_t s) {
  switch (f_dtype) {
    case agg::kF32: return launch_op<V, float>(op, v, f, n, tile, thr, out, s);
    case agg::kI32:
      return launch_op<V, int32_t>(op, v, f, n, tile, thr, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// values: n elements of v_dtype; filt: n elements of f_dtype (codes in
// agg_tile.cuh: 0 float32, 1 int32); op: index into < <= > >= == !=;
// out: ceil(n / tile) x 4 float32.
extern "C" int filter_agg_launch(const void* values, int v_dtype,
                                 const void* filt, int f_dtype, long long n,
                                 int tile, int op, float thr, void* out,
                                 void* stream) {
  if (tile <= 0 || n < 0 || agg::n_tiles(n, tile) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v_dtype) {
    case agg::kF32:
      return launch_f<float>(f_dtype, op, values, filt, n, tile, thr, out, s);
    case agg::kI32:
      return launch_f<int32_t>(f_dtype, op, values, filt, n, tile, thr, out,
                               s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
