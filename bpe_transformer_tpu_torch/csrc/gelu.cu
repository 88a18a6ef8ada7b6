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
// Bound on the H100: bytes.  15 to 20 float32 operations an element (the
// backward a few more) against 4 bytes moved in bf16 (read x, write y; the
// backward 6: read x and g, write dx), 8 and 12 in float32: 2 to 5
// operations a byte, below the 20 a byte (67 TFLOP/s over 3.35 TB/s) at
// which the CUDA cores' float32 rate would bind.
//
// Design: the TPU kernel pads the input to (256, 128) tiles and walks them
// on a sequential grid.  Here nothing is padded: a grid-stride loop over
// 16-byte vectors (4 float32 or 8 bf16 elements a thread a step, neighbouring
// threads on neighbouring vectors) covers n / V vectors, and a scalar tail
// the last n % V elements.  The grid is capped at 4096 blocks of 256
// threads, enough to keep every SM's loads in flight.

#include "common.cuh"

using namespace port;

namespace {

constexpr int NT = 256;            // threads per block
constexpr long long MAX_BLOCKS = 4096;
constexpr float K0 = 0.79788456f;  // sqrt(2 / pi), gelu.py's _SQRT_2_OVER_PI
constexpr float C = 0.044715f;     // gelu.py's _C
constexpr float C3 = (float)(3.0 * 0.044715);  // 3.0 * _C, folded in double as Python folds it

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

template <typename T>
__global__ void __launch_bounds__(NT)
gelu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  constexpr int V = Vec16<T>::N;
  const long long nvec = n / V;
  const long long stride = (long long)gridDim.x * NT;
  const long long first = (long long)blockIdx.x * NT + threadIdx.x;
  for (long long i = first; i < nvec; i += stride) {
    float v[V];
    load16(x + i * V, v);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = gelu_f(v[k]);
    store16(y + i * V, v);
  }
  for (long long i = nvec * V + first; i < n; i += stride) y[i] = from_f<T>(gelu_f(to_f(x[i])));
}

template <typename T>
__global__ void __launch_bounds__(NT)
gelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                long long n) {
  constexpr int V = Vec16<T>::N;
  const long long nvec = n / V;
  const long long stride = (long long)gridDim.x * NT;
  const long long first = (long long)blockIdx.x * NT + threadIdx.x;
  for (long long i = first; i < nvec; i += stride) {
    float xv[V], gv[V];
    load16(x + i * V, xv);
    load16(g + i * V, gv);
#pragma unroll
    for (int k = 0; k < V; ++k) xv[k] = gelu_bwd_f(xv[k], gv[k]);
    store16(dx + i * V, xv);
  }
  for (long long i = nvec * V + first; i < n; i += stride)
    dx[i] = from_f<T>(gelu_bwd_f(to_f(x[i]), to_f(g[i])));
}

template <typename T>
int grid_for(long long n) {
  const long long work = (n + Vec16<T>::N - 1) / Vec16<T>::N;
  const long long blocks = (work + NT - 1) / NT;
  return (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

}  // namespace

// x, y contiguous, 16-byte aligned, n elements of one dtype (F32 or BF16).
extern "C" int gelu_launch(int dtype, const void* x, void* y, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32) {
    gelu_fwd_kernel<float><<<grid_for<float>(n), NT, 0, s>>>((const float*)x, (float*)y, n);
  } else if (dtype == BF16) {
    gelu_fwd_kernel<__nv_bfloat16><<<grid_for<__nv_bfloat16>(n), NT, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, g, dx contiguous, 16-byte aligned, n elements of one dtype.
extern "C" int gelu_bwd_launch(int dtype, const void* x, const void* g, void* dx, int n,
                               void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32) {
    gelu_bwd_kernel<float><<<grid_for<float>(n), NT, 0, s>>>((const float*)x, (const float*)g,
                                                            (float*)dx, n);
  } else if (dtype == BF16) {
    gelu_bwd_kernel<__nv_bfloat16><<<grid_for<__nv_bfloat16>(n), NT, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (__nv_bfloat16*)dx, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
