// Tanh-approximation GeLU, forward and backward.
//
// Replaces: bpe_transformer_tpu/kernels/pallas/gelu.py
//   gelu (line 41; kernel _gelu_kernel at 29, pallas_call at 60), and its
//   custom JVP _gelu_jvp (line 83), which the JAX package runs in XLA
//   outside Pallas: here it is a kernel of its own, one launch in place of
//   about ten elementwise passes.
// Computes, element by element in float32, rounded once to the input type:
//   forward   u = 0.79788456 (x + ((0.044715 x) x) x)
//             e = exp(min(2 u, 30)),  y = (0.5 x) (1 + (e - 1) / (e + 1))
//   backward  t = tanh(u)
//             dx = (0.5 (1 + t) + ((0.5 x) (1 - t t)) 0.79788456 (1 + (3c x) x)) g
//   The clamp keeps exp finite (gelu(11) == 11, gelu(-1000) == 0, no NaN).
//   Every product, sum and quotient is a rounded intrinsic (__fmul_rn,
//   __fadd_rn, __fdiv_rn) in the JAX expression's order of association, so
//   nvcc contracts nothing into an FMA and the kernel does the plain
//   version's float32 operations one for one; only expf and tanhf may differ
//   from PyTorch's own exp and tanh in the last place.
//
// Bound on the H100: bytes, with issue close behind.  4 bytes an element in
// bf16 (read x, write y; the backward 6: read x and g, write dx), 8 and 12 in
// float32, against about 36 SASS instructions an element for the forward
// (the accurate expf and the IEEE division most of them) and 37 for the
// backward: at m 8192 x 3072 bf16 the forward's 100.7 MB take 0.030 ms at
// 3.35 TB/s and its ~28M warp instructions 0.027 ms of issue on 132 SMs x 4
// schedulers at 1980 MHz.  The float32 arithmetic may not change (the negative
// tail cancels: one ulp of t is many bf16 ulps of y), so the design can only
// keep the bytes in flight while the arithmetic issues.
//
// Design: the TPU kernel pads the input to (256, 128) tiles and walks them
// on a sequential grid.  Here nothing is padded.  The input is cut into
// chunks of 256 x U 16-byte vectors (4 float32 or 8 bf16 elements each), one
// block a chunk, and each thread loads its U vectors (256 apart, so every
// load is coalesced) before any arithmetic (U is FWD_VECS or BWD_VECS).
// Loads go through the non-coherent path without allocating in L1 and
// stores are marked streaming, since every byte is touched once.  Index arithmetic is 32-bit
// (the wrapper caps n).  The scalar tail (n % V elements) is the last
// block's.  Grids of the card's resident blocks that loop over the chunks,
// with or without the next chunk's loads issued before the current chunk's
// arithmetic, were slower.

#include "common.cuh"

using namespace port;

namespace {

constexpr int NT = 256;            // threads per block
constexpr float K0 = 0.79788456f;  // sqrt(2 / pi), gelu.py's _SQRT_2_OVER_PI
constexpr float C = 0.044715f;     // gelu.py's _C
constexpr float C3 = (float)(3.0 * 0.044715);  // 3.0 * _C, folded in double as Python folds it
// 16-byte vectors each thread loads before its arithmetic, per kernel: of
// 1, 2 and 4, the fastest on the card at the training shape (PERF.md, B11).
constexpr int FWD_VECS = 2;
constexpr int BWD_VECS = 1;
// The most elements a launch takes, leaving room for the 32-bit index of a
// chunk's last vector past the end (kernels/gelu.py _MAX_ELEMS).
constexpr int MAX_N = 0x7fffffff - 4 * NT * 8;

// u = K0 (x + ((C x) x) x)
__device__ __forceinline__ float gelu_inner(float x) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(C, x), x), x);
  return __fmul_rn(K0, __fadd_rn(x, cube));
}

__device__ __forceinline__ float gelu_f(float x) {
  const float e = expf(fminf(__fmul_rn(2.f, gelu_inner(x)), 30.f));
  const float t = __fdiv_rn(__fsub_rn(e, 1.f), __fadd_rn(e, 1.f));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, t));
}

__device__ __forceinline__ float gelu_bwd_f(float x, float g) {
  const float t = tanhf(gelu_inner(x));
  const float du = __fmul_rn(K0, __fadd_rn(1.f, __fmul_rn(__fmul_rn(C3, x), x)));
  const float a = __fmul_rn(0.5f, __fadd_rn(1.f, t));
  const float b = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, x), __fsub_rn(1.f, __fmul_rn(t, t))), du);
  return __fmul_rn(__fadd_rn(a, b), g);
}

// 16 bytes through the non-coherent path, not kept in L1; 16 bytes stored
// as streaming (evict first).
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ void st_stream(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// A 16-byte vector to float32 (exact) and back (round to nearest even).
__device__ __forceinline__ void unpack(uint4 r, float (&o)[4]) {
  o[0] = __uint_as_float(r.x);
  o[1] = __uint_as_float(r.y);
  o[2] = __uint_as_float(r.z);
  o[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(uint4 r, float (&o)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Chunk blockIdx.x: NT * U vectors from vector blockIdx.x * NT * U.
template <typename T, int U>
__global__ void __launch_bounds__(NT)
gelu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int n) {
  constexpr int V = Vec16<T>::N;
  const int nvec = n / V, i0 = (int)(blockIdx.x * NT * U + threadIdx.x);
  uint4 r[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (i0 + u * NT < nvec) r[u] = ld_stream(x + (i0 + u * NT) * V);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (i0 + u * NT < nvec) {
      float v[V];
      unpack(r[u], v);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = gelu_f(v[k]);
      st_stream(y + (i0 + u * NT) * V, pack(v));
    }
  }
  if (blockIdx.x == gridDim.x - 1)
    for (int i = nvec * V + (int)threadIdx.x; i < n; i += NT) y[i] = from_f<T>(gelu_f(to_f(x[i])));
}

template <typename T, int U>
__global__ void __launch_bounds__(NT)
gelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx, int n) {
  constexpr int V = Vec16<T>::N;
  const int nvec = n / V, i0 = (int)(blockIdx.x * NT * U + threadIdx.x);
  uint4 rx[U], rg[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (i0 + u * NT < nvec) {
      rx[u] = ld_stream(x + (i0 + u * NT) * V);
      rg[u] = ld_stream(g + (i0 + u * NT) * V);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (i0 + u * NT < nvec) {
      float xv[V], gv[V];
      unpack(rx[u], xv);
      unpack(rg[u], gv);
#pragma unroll
      for (int k = 0; k < V; ++k) xv[k] = gelu_bwd_f(xv[k], gv[k]);
      st_stream(dx + (i0 + u * NT) * V, pack(xv));
    }
  }
  if (blockIdx.x == gridDim.x - 1)
    for (int i = nvec * V + (int)threadIdx.x; i < n; i += NT)
      dx[i] = from_f<T>(gelu_bwd_f(to_f(x[i]), to_f(g[i])));
}

// One block a chunk of NT * U vectors (one block when there is only a tail).
template <typename T, int U>
unsigned grid_for(int n) {
  const int chunks = (n / Vec16<T>::N + NT * U - 1) / (NT * U);
  return chunks < 1 ? 1u : (unsigned)chunks;
}

template <typename T>
cudaError_t fwd_t(const void* x, void* y, int n, cudaStream_t s) {
  gelu_fwd_kernel<T, FWD_VECS><<<grid_for<T, FWD_VECS>(n), NT, 0, s>>>((const T*)x, (T*)y, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_t(const void* x, const void* g, void* dx, int n, cudaStream_t s) {
  gelu_bwd_kernel<T, BWD_VECS><<<grid_for<T, BWD_VECS>(n), NT, 0, s>>>((const T*)x, (const T*)g,
                                                                      (T*)dx, n);
  return cudaGetLastError();
}

}  // namespace

// x, y contiguous, 16-byte aligned, n elements of one dtype (F32 or BF16).
extern "C" int gelu_launch(int dtype, const void* x, void* y, int n, void* stream) {
  if (n <= 0 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32) return (int)fwd_t<float>(x, y, n, s);
  if (dtype == BF16) return (int)fwd_t<__nv_bfloat16>(x, y, n, s);
  return (int)cudaErrorInvalidValue;
}

// x, g, dx contiguous, 16-byte aligned, n elements of one dtype.
extern "C" int gelu_bwd_launch(int dtype, const void* x, const void* g, void* dx, int n,
                               void* stream) {
  if (n <= 0 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32) return (int)bwd_t<float>(x, g, dx, n, s);
  if (dtype == BF16) return (int)bwd_t<__nv_bfloat16>(x, g, dx, n, s);
  return (int)cudaErrorInvalidValue;
}
