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
// Bound on the H100: operations from a few dozen rows up (6 m d ff flops
// against (2 m d + 3 d ff) elements: at the training m 8192, d 768, ff 2048
// that is 77 GFLOP, 0.078 ms at the bf16 tensor-core rate); bytes for a
// decode tick (m = slots: the three weight matrices are streamed once for a
// handful of rows, 0.0028 ms at m 8).
//
// Two designs, picked by the wrapper (kernels/swiglu.py) per call:
//
// * Tensor cores (bf16 at every m, d and ff multiples of 8: they beat the
//   CUDA-core kernel from one row up, chip_smoke.py's crossover sweep):
//   two wgmma GEMM kernels.  The TPU kernel keeps h in VMEM and adds each ff
//   slice's down projection into y.  Fused here, a block would need either a
//   (rows x d_model) float32 accumulator or a recompute of the up products for
//   every d_model chunk (3x the up products at d 768), so h goes through
//   device memory once instead, in bf16 (m ff 2 bytes: 32 MB and ~0.02 ms of
//   traffic at the training shape).  The first kernel runs the up and gate
//   products of a 128 x 128 tile of h (two accumulators of 64 x 128 per
//   warpgroup) and applies silu(u) g in registers before rounding h to bf16;
//   the second runs h w2^T.  Both stream 64-deep K slices of the two
//   operands (both K-major: x and h by rows, w1/w3/w2 as stored) through a
//   four-stage ring that one thread fills with TMA loads in the 128-byte
//   swizzle, signalled by one mbarrier a stage; each warpgroup issues the
//   four m64n128k16 wgmmas of a slice, keeps one slice in flight, and frees
//   the slice before it for the next load.  Accumulation is float32.
// * CUDA cores (float32, which must keep float32 accuracy and may not use
//   TF32; and bf16 at widths TMA cannot describe):
//   the TPU kernel walks ff slices sequentially inside one grid row and keeps
//   y in VMEM.  Blocks here run in parallel and in no order, so the ff axis
//   is split over gridDim.y blocks for parallelism at small m: block (i, s)
//   takes the 16-row tile i and the 32-wide ff slices s, s + nsplit, ...
//   For each slice it computes the 16 x 32 up and gate products from x and
//   w1/w3 tiles staged in shared memory, forms h in shared memory (h never
//   reaches device memory), and adds h w2[:, slice]^T into float32 y
//   partials held in registers (thread t owns output columns t, t + 256,
//   ...).  A second small kernel sums the nsplit float32 partials and rounds
//   y to the input type; the sum order is fixed, so results do not vary from
//   run to run.  A block holds at most 8 * 256 = 2048 output columns in
//   registers; a wider d_model is cut into chunks of 2048 columns over
//   gridDim.z, and the blocks of each chunk recompute the slice's up
//   products (h) for themselves.

#include "common.cuh"
#include "hopper.cuh"

using namespace port;

namespace {

constexpr int BM = 16;   // rows per tile
constexpr int BF = 32;   // ff columns per slice
constexpr int BC = 32;   // d columns per staged tile of the up products
constexpr int NT = 256;  // threads per block
constexpr int MAX_NR = 8;  // output columns per thread: NT * MAX_NR per block

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
  const int n0 = blockIdx.z * NT * MAX_NR;  // this block's output columns start here
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
      const int n = n0 + tid + NT * r;
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
    const int n = n0 + tid + NT * r;
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
  const int nr = d > NT * MAX_NR ? MAX_NR : (d + NT - 1) / NT;
  const int n_chunks = (d + NT * MAX_NR - 1) / (NT * MAX_NR);
  const dim3 grid((m + BM - 1) / BM, nsplit, n_chunks), block(NT);
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

// ------------------------------------------------------- tensor-core path

namespace tc {

using namespace port::sm90;

constexpr int BM = 128;  // rows of a block tile: two warpgroups of 64
constexpr int BN = 128;  // output columns of a block tile
constexpr int BK = 64;   // K slice: one 128-byte swizzled row per tile row
constexpr int STAGES = 4;
constexpr int NT = 256;
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;

template <bool DUAL> struct Smem {
  static constexpr int STAGE = A_BYTES + (DUAL ? 2 : 1) * B_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + STAGES * 8 + 1024;  // + slack to align to 1024
};

// One K slice kt of A (rows m0..) and B0/B1 (rows n0..) into stage st.
template <bool DUAL>
__device__ __forceinline__ void load_slice(uint8_t* stage, uint64_t* bar, const CUtensorMap* a,
                                           const CUtensorMap* b0, const CUtensorMap* b1, int kt,
                                           int m0, int n0) {
  mbar_expect_tx(bar, Smem<DUAL>::STAGE);
  tma_load_2d(stage, a, bar, kt * BK, m0);
  tma_load_2d(stage + A_BYTES, b0, bar, kt * BK, n0);
  if (DUAL) tma_load_2d(stage + A_BYTES + B_BYTES, b1, bar, kt * BK, n0);
}

// out (M, N) bf16 = A (M, K) B0 (N, K)^T, or with DUAL
// bf16(silu(A B0^T) * (A B1^T)); float32 accumulation.
template <bool DUAL>
__global__ void __launch_bounds__(NT, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b0,
            const __grid_constant__ CUtensorMap tm_b1, __nv_bfloat16* __restrict__ out, int M,
            int N, int K) {
  using L = Smem<DUAL>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = (K + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < STAGES && s < nk; ++s)
      load_slice<DUAL>(sm + s * L::STAGE, &full[s], &tm_a, &tm_b0, &tm_b1, s, m0, n0);
  }

  float acc0[64], acc1[DUAL ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DUAL ? 64 : 1); ++i) acc1[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(&full[st], (kt / STAGES) & 1);
    const uint8_t* s = sm + st * L::STAGE;
    const uint64_t da = desc_sw128(s + wg * 64 * BK * 2);
    const uint64_t db0 = desc_sw128(s + A_BYTES);
    const uint64_t db1 = desc_sw128(s + A_BYTES + B_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_128_ss(acc0, da + 2 * kk, db0 + 2 * kk, 1);
      if constexpr (DUAL) wgmma_128_ss(acc1, da + 2 * kk, db1 + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the slice before this one is consumed by this warpgroup
    __syncthreads();  // ... and by the other one
    if (tid == 0 && kt >= 1 && kt - 1 + STAGES < nk) {
      const int ps = (kt - 1) % STAGES;
      load_slice<DUAL>(sm + ps * L::STAGE, &full[ps], &tm_a, &tm_b0, &tm_b1, kt - 1 + STAGES, m0,
                       n0);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);

  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int c = n0 + 8 * n + 2 * (lane % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      float v0 = acc0[4 * n + 2 * half], v1 = acc0[4 * n + 2 * half + 1];
      if constexpr (DUAL) {
        v0 = silu(v0) * acc1[4 * n + 2 * half];
        v1 = silu(v1) * acc1[4 * n + 2 * half + 1];
      }
      if (r < M && c < N) {
        __nv_bfloat16* o = out + (size_t)r * N + c;
        if (c + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          *o = __float2bfloat16(v0);
        }
      }
    }
  }
}

cudaError_t launch(const void* x, const void* w1, const void* w3, const void* w2, void* h, void* y,
                   int m, int d, int ff, cudaStream_t stream) {
  CUtensorMap tx, tw1, tw3, th, tw2;
  const uint32_t box_a[2] = {BK, BM}, box_b[2] = {BK, BN};
  const uint64_t dx[2] = {(uint64_t)d, (uint64_t)m}, dw[2] = {(uint64_t)d, (uint64_t)ff};
  const uint64_t dh[2] = {(uint64_t)ff, (uint64_t)m}, dw2[2] = {(uint64_t)ff, (uint64_t)d};
  if (!encode_bf16(&tx, x, 2, dx, box_a) || !encode_bf16(&tw1, w1, 2, dw, box_b) ||
      !encode_bf16(&tw3, w3, 2, dw, box_b) || !encode_bf16(&th, h, 2, dh, box_a) ||
      !encode_bf16(&tw2, w2, 2, dw2, box_b))
    return cudaErrorInvalidValue;
  static int ready_up = -1, ready_down = -1;
  cudaError_t err = allow_smem(gemm_kernel<true>, Smem<true>::BYTES, ready_up);
  if (err != cudaSuccess) return err;
  err = allow_smem(gemm_kernel<false>, Smem<false>::BYTES, ready_down);
  if (err != cudaSuccess) return err;
  const int m_tiles = (m + BM - 1) / BM;
  gemm_kernel<true><<<dim3((ff + BN - 1) / BN, m_tiles), NT, Smem<true>::BYTES, stream>>>(
      tx, tw1, tw3, (__nv_bfloat16*)h, m, ff, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gemm_kernel<false><<<dim3((d + BN - 1) / BN, m_tiles), NT, Smem<false>::BYTES, stream>>>(
      th, tw2, tw2, (__nv_bfloat16*)y, m, d, ff);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x (m, d), w1/w3 (ff, d), w2 (d, ff), y (m, d) contiguous; ws float32
// (nsplit, m, d) scratch.  Any d.
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

// bf16 only: x (m, d), w1/w3 (ff, d), w2 (d, ff), h (m, ff) bf16 scratch,
// y (m, d); all contiguous and 16-byte aligned, d and ff multiples of 8.
extern "C" int swiglu_tc_launch(int dtype, const void* x, const void* w1, const void* w3,
                                const void* w2, void* h, void* y, int m, int d, int ff,
                                void* stream) {
  if (dtype != BF16 || m <= 0 || d <= 0 || ff <= 0 || d % 8 || ff % 8 || m > 65535 * tc::BM)
    return (int)cudaErrorInvalidValue;
  return (int)tc::launch(x, w1, w3, w2, h, y, m, d, ff, (cudaStream_t)stream);
}
