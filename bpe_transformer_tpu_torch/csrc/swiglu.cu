// Fused SwiGLU feed-forward forward pass.
//
// Replaces: bpe_transformer_tpu/kernels/pallas/swiglu.py
//   swiglu_fused (line 76) -> _swiglu_impl (line 54; kernel _swiglu_kernel at
//   31, pallas_call at 58).
// Computes: y = (round_x(silu(x w1^T) * (x w3^T))) w2^T
//   x (m, d), w1/w3 (ff, d), w2 (d, ff) -> y (m, d).  The gate h is rounded to
//   the input type before the down projection, as the TPU kernel does; unlike
//   the TPU kernel, y accumulates in float32 (the TPU kernel adds each ff
//   slice's contribution into a y held in the input type).
//
// Bound on the H100: bytes for a decode tick (m = slots: the three weight
// matrices are streamed once for a handful of rows), operations for a prefill
// bucket (m in the hundreds: 6 m d ff flops).  This first kernel does its
// products on the CUDA cores in float32; tensor-core tiles are later work.
//
// Design: the TPU kernel walks ff slices sequentially inside one grid row and
// keeps y in VMEM.  Blocks here run in parallel and in no order, so the ff
// axis is split over gridDim.y blocks for parallelism at small m: block
// (i, s) takes the 16-row tile i and the 32-wide ff slices s, s + nsplit, ...
// For each slice it computes the 16 x 32 up and gate products from x and
// w1/w3 tiles staged in shared memory, forms h in shared memory (h never
// reaches device memory), and adds h w2[:, slice]^T into float32 y partials
// held in registers (thread t owns output columns t, t + 256, ...).  A second
// small kernel sums the nsplit float32 partials and rounds y to the input
// type; the sum order is fixed, so results do not vary from run to run.

#include "common.cuh"

using namespace port;

namespace {

constexpr int BM = 16;   // rows per tile
constexpr int BF = 32;   // ff columns per slice
constexpr int BC = 32;   // d columns per staged tile of the up products
constexpr int NT = 256;  // threads per block

__device__ __forceinline__ float silu(float u) { return u / (1.f + expf(-u)); }

template <typename T, int NR>
__global__ void __launch_bounds__(NT)
swiglu_partial_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ w3,
                      const T* __restrict__ w2, float* __restrict__ ws, int m, int d, int ff) {
  __shared__ float xs[BM][BC + 1];
  __shared__ float w1s[BF][BC + 1];
  __shared__ float w3s[BF][BC + 1];
  __shared__ float hs[BM][BF];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int n_slices = (ff + BF - 1) / BF;
  const int ui = tid / 16;  // up-product row
  const int uf = tid % 16;  // up-product columns uf and uf + 16

  float y[BM][NR];
#pragma unroll
  for (int i = 0; i < BM; ++i) {
#pragma unroll
    for (int r = 0; r < NR; ++r) y[i][r] = 0.f;
  }

  for (int fs = split; fs < n_slices; fs += nsplit) {
    const int f0 = fs * BF;
    float up0 = 0.f, up1 = 0.f, gt0 = 0.f, gt1 = 0.f;
    for (int c0 = 0; c0 < d; c0 += BC) {
      __syncthreads();  // the previous tiles (and hs) are consumed
      for (int i = tid; i < BM * BC; i += NT) {
        const int r = i / BC, c = c0 + i % BC;
        xs[r][i % BC] = (m0 + r < m && c < d) ? to_f(x[(size_t)(m0 + r) * d + c]) : 0.f;
      }
      for (int i = tid; i < BF * BC; i += NT) {
        const int r = i / BC, c = c0 + i % BC;
        const bool ok = f0 + r < ff && c < d;
        const size_t g = (size_t)(f0 + r) * d + c;
        w1s[r][i % BC] = ok ? to_f(w1[g]) : 0.f;
        w3s[r][i % BC] = ok ? to_f(w3[g]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < BC; ++c) {
        const float xv = xs[ui][c];
        up0 += xv * w1s[uf][c];
        up1 += xv * w1s[uf + 16][c];
        gt0 += xv * w3s[uf][c];
        gt1 += xv * w3s[uf + 16][c];
      }
    }
    hs[ui][uf] = to_f(from_f<T>(silu(up0) * gt0));
    hs[ui][uf + 16] = to_f(from_f<T>(silu(up1) * gt1));
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int n = tid + NT * r;
      if (n < d) {
        float w2v[BF];
        const T* w2r = w2 + (size_t)n * ff + f0;
#pragma unroll
        for (int f = 0; f < BF; ++f) w2v[f] = (f0 + f < ff) ? to_f(w2r[f]) : 0.f;
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          float a = 0.f;
#pragma unroll
          for (int f = 0; f < BF; ++f) a += hs[i][f] * w2v[f];
          y[i][r] += a;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int n = tid + NT * r;
    if (n >= d) continue;
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      if (m0 + i < m) ws[((size_t)split * m + m0 + i) * d + n] = y[i][r];
    }
  }
}

template <typename T>
__global__ void swiglu_reduce_kernel(const float* __restrict__ ws, T* __restrict__ y, int nsplit,
                                     size_t md) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < md;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s) a += ws[(size_t)s * md + i];
    y[i] = from_f<T>(a);
  }
}

template <typename T>
cudaError_t launch_t(const void* x, const void* w1, const void* w3, const void* w2, float* ws,
                     void* y, int m, int d, int ff, int nsplit, cudaStream_t stream) {
  const int nr = (d + NT - 1) / NT;
  const dim3 grid((m + BM - 1) / BM, nsplit), block(NT);
  const T *xp = (const T*)x, *w1p = (const T*)w1, *w3p = (const T*)w3, *w2p = (const T*)w2;
#define PORT_SWIGLU_CASE(R)                                                                   \
  case R:                                                                                     \
    swiglu_partial_kernel<T, R><<<grid, block, 0, stream>>>(xp, w1p, w3p, w2p, ws, m, d, ff); \
    break;
  switch (nr) {
    PORT_SWIGLU_CASE(1)
    PORT_SWIGLU_CASE(2)
    PORT_SWIGLU_CASE(3)
    PORT_SWIGLU_CASE(4)
    PORT_SWIGLU_CASE(5)
    PORT_SWIGLU_CASE(6)
    PORT_SWIGLU_CASE(7)
    PORT_SWIGLU_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PORT_SWIGLU_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t md = (size_t)m * d;
  const int blocks = (int)((md + 255) / 256 < 4096 ? (md + 255) / 256 : 4096);
  swiglu_reduce_kernel<T><<<blocks, 256, 0, stream>>>(ws, (T*)y, nsplit, md);
  return cudaGetLastError();
}

}  // namespace

// x (m, d), w1/w3 (ff, d), w2 (d, ff), y (m, d) contiguous; ws float32
// (nsplit, m, d) scratch.  d <= 2048.
extern "C" int swiglu_launch(int dtype, const void* x, const void* w1, const void* w3,
                             const void* w2, void* ws, void* y, int m, int d, int ff, int nsplit,
                             void* stream) {
  if (m <= 0 || d <= 0 || ff <= 0 || nsplit <= 0 || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* w = (float*)ws;
  if (dtype == F32) return (int)launch_t<float>(x, w1, w3, w2, w, y, m, d, ff, nsplit, s);
  if (dtype == BF16) return (int)launch_t<__nv_bfloat16>(x, w1, w3, w2, w, y, m, d, ff, nsplit, s);
  return (int)cudaErrorInvalidValue;
}
