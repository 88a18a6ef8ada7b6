// Causal flash-attention forward.
//
// Replaces: bpe_transformer_tpu/kernels/pallas/flash_attention.py
//   flash_attention (line 462) -> _flash_impl (line 164; kernel _flash_kernel
//   at 70, pallas_call at 264), as prefill calls it (causal=True, no lse).
// Computes: out = softmax(q k^T / sqrt(d) + causal mask) v per (batch*head),
//   q/k/v/out (BH, S, d), with online softmax: no (S, S) matrix is stored.
//
// Bound on the H100: operations at long prompts (4 * d * S^2 / 2 flops per
// head against 4 * S * d elements moved), bytes at short ones.  This first
// kernel runs its products on the CUDA cores in float32, not on the tensor
// cores, so it sits well above the bound: wgmma tiles are later work.
//
// Design: one block per (64-query tile, batch*head).  The TPU's sequential key
// grid becomes a loop over 32-key tiles that the block stages in shared memory
// (as float32) and that every query row of the tile reuses; the loop stops at
// the tile's last row, so keys above the diagonal are neither loaded nor
// computed, and a ragged S is masked, not padded (the TPU pads S to its block
// and d to 128 lanes).  Each query row belongs to TPR = max(1, d / 32)
// neighbouring threads of one warp, each holding d / TPR interleaved columns
// of q and of the float32 accumulator in registers (so no thread holds more
// than 32 of each); the row's scores are summed across those threads with warp
// shuffles.  Interleaving the columns keeps the shared-memory reads of one key
// row on distinct banks, and rows of the same warp read the same key row as a
// broadcast.

#include "common.cuh"

using namespace port;

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 32;  // keys per shared-memory tile

template <typename T, int D>
__global__ void __launch_bounds__(BQ * (D <= 32 ? 1 : D / 32))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int S, float scale) {
  constexpr int TPR = D <= 32 ? 1 : D / 32;  // threads per query row
  constexpr int DT = D / TPR;                // columns per thread
  constexpr int NT = BQ * TPR;

  __shared__ float k_sh[BK][D];
  __shared__ float v_sh[BK][D];

  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int row = q0 + threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const bool row_live = row < S;

  float qr[DT], acc[DT];
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    qr[c] = row_live ? to_f(q[base + (size_t)row * D + c * TPR + sub]) * scale : 0.f;
    acc[c] = 0.f;
  }
  float m = MASK, l = 0.f;

  const int last_key = min(q0 + BQ, S) - 1;  // causal: nothing past the tile's last row
  for (int k0 = 0; k0 <= last_key; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * D; i += NT) {
      const int kk = k0 + i / D;
      const bool ok = kk < S;
      const size_t g = base + (size_t)kk * D + i % D;
      k_sh[i / D][i % D] = ok ? to_f(k[g]) : 0.f;
      v_sh[i / D][i % D] = ok ? to_f(v[g]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float mt = MASK;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < DT; ++c) part += qr[c] * k_sh[j][c * TPR + sub];
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      const int key = k0 + j;
      s[j] = (key <= row && key < S) ? part : MASK;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[c] += p * v_sh[j][c * TPR + sub];
    }
    m = m_new;
  }
  if (row_live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < DT; ++c) out[base + (size_t)row * D + c * TPR + sub] = from_f<T>(acc[c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, int BH, int S,
                     cudaStream_t stream) {
  constexpr int TPR = D <= 32 ? 1 : D / 32;
  const dim3 grid((S + BQ - 1) / BQ, BH), block(BQ * TPR);
  flash_fwd_kernel<T, D><<<grid, block, 0, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                    (T*)out, S, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int d, const void* q, const void* k, const void* v, void* out, int BH,
                     int S, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_d<T, 16>(q, k, v, out, BH, S, stream);
    case 32: return launch_d<T, 32>(q, k, v, out, BH, S, stream);
    case 64: return launch_d<T, 64>(q, k, v, out, BH, S, stream);
    case 128: return launch_d<T, 128>(q, k, v, out, BH, S, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/out (BH, S, d), contiguous; causal; d in {16, 32, 64, 128}.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      void* out, int BH, int S, int d, void* stream) {
  if (BH <= 0 || S <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32) return (int)launch_t<float>(d, q, k, v, out, BH, S, s);
  if (dtype == BF16) return (int)launch_t<__nv_bfloat16>(d, q, k, v, out, BH, S, s);
  return (int)cudaErrorInvalidValue;
}
