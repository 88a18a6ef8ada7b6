// Causal flash-attention forward, optionally with the row logsumexp and with
// RoPE applied to Q/K inside the kernel.
//
// Replaces: bpe_transformer_tpu/kernels/pallas/flash_attention.py
//   flash_attention (line 462) -> _flash_impl (line 164; kernel _flash_kernel
//   at 70, pallas_call at 264): the causal forward prefill calls (no lse), the
//   training forward (return_lse=True; lse store at 146-151), and
//   flash_attention_with_rope (line 569; in-kernel rotation at 76-116).
// Computes: out = softmax(q k^T / sqrt(d) + causal mask) v per (batch*head),
//   q/k/v/out (BH, S, d), with online softmax: no (S, S) matrix is stored.
//   lse (BH, S) float32, when asked for, is m + log(l) per query row in units
//   of the scaled scores, the statistic the FA-2 backward recomputes P from.
//   With cos/sin (S, d/2) float32 tables (rows gathered at the token
//   positions), q and k are first rotated pair by pair:
//   (x_e, x_o) -> (x_e c - x_o s, x_e s + x_o c).
//
// Bound on the H100: operations at long sequences (4 * d * S^2 / 2 flops per
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
// broadcast.  The lse is one float per row (the TPU writes 128 lane copies
// for its VMEM tiling).  RoPE: the TPU permutes Q/K to a half-split layout so
// its rotation is two dense FMAs on 128-lane tiles; here each element is
// rotated as it is loaded, reading its pair partner (column ^ 1) from the same
// cached row, so no permuted copy exists: q is scaled and rotated once per
// query tile into registers, k on every staging of a key tile.

#include "common.cuh"

using namespace port;

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 32;  // keys per shared-memory tile

// Element `col` of row `row_ptr` (D wide) after the interleaved-pair rotation
// by the table row `cs`/`sn` (D / 2 wide).
template <typename T>
__device__ __forceinline__ float rotated(const T* row_ptr, int col, const float* cs,
                                         const float* sn) {
  const float x = to_f(row_ptr[col]);
  const float partner = to_f(row_ptr[col ^ 1]);
  const float c = cs[col >> 1], s = sn[col >> 1];
  return (col & 1) ? partner * s + x * c : x * c - partner * s;
}

template <typename T, int D, bool ROPE>
__global__ void __launch_bounds__(BQ * (D <= 32 ? 1 : D / 32))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                 T* __restrict__ out, float* __restrict__ lse, int S, float scale) {
  constexpr int TPR = D <= 32 ? 1 : D / 32;  // threads per query row
  constexpr int DT = D / TPR;                // columns per thread
  constexpr int NT = BQ * TPR;
  constexpr int H = D / 2;

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
    const int col = c * TPR + sub;
    float x = 0.f;
    if (row_live) {
      const T* qrow = q + base + (size_t)row * D;
      x = ROPE ? rotated(qrow, col, cos_t + (size_t)row * H, sin_t + (size_t)row * H)
               : to_f(qrow[col]);
    }
    qr[c] = x * scale;
    acc[c] = 0.f;
  }
  float m = MASK, l = 0.f;

  const int last_key = min(q0 + BQ, S) - 1;  // causal: nothing past the tile's last row
  for (int k0 = 0; k0 <= last_key; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * D; i += NT) {
      const int kk = k0 + i / D, col = i % D;
      const bool ok = kk < S;
      const size_t g = base + (size_t)kk * D;
      float kv = 0.f;
      if (ok) {
        kv = ROPE ? rotated(k + g, col, cos_t + (size_t)kk * H, sin_t + (size_t)kk * H)
                  : to_f(k[g + col]);
      }
      k_sh[i / D][col] = kv;
      v_sh[i / D][col] = ok ? to_f(v[g + col]) : 0.f;
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
    const float denom = fmaxf(l, 1e-30f);
    const float inv = 1.f / denom;
#pragma unroll
    for (int c = 0; c < DT; ++c) out[base + (size_t)row * D + c * TPR + sub] = from_f<T>(acc[c] * inv);
    if (lse != nullptr && sub == 0) lse[(size_t)blockIdx.y * S + row] = m + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const float* cs, const float* sn,
                     void* out, float* lse, int BH, int S, cudaStream_t stream) {
  constexpr int TPR = D <= 32 ? 1 : D / 32;
  const dim3 grid((S + BQ - 1) / BQ, BH), block(BQ * TPR);
  const float scale = 1.0f / sqrtf((float)D);
  if (cs != nullptr) {
    flash_fwd_kernel<T, D, true><<<grid, block, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, cs, sn, (T*)out, lse, S, scale);
  } else {
    flash_fwd_kernel<T, D, false><<<grid, block, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, nullptr, nullptr, (T*)out, lse, S, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int d, const void* q, const void* k, const void* v, const float* cs,
                     const float* sn, void* out, float* lse, int BH, int S, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_d<T, 16>(q, k, v, cs, sn, out, lse, BH, S, stream);
    case 32: return launch_d<T, 32>(q, k, v, cs, sn, out, lse, BH, S, stream);
    case 64: return launch_d<T, 64>(q, k, v, cs, sn, out, lse, BH, S, stream);
    case 128: return launch_d<T, 128>(q, k, v, cs, sn, out, lse, BH, S, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/out (BH, S, d), contiguous; causal; d in {16, 32, 64, 128}.
// cos/sin: NULL, or float32 (S, d/2) tables for RoPE in the kernel (both or
// neither).  lse: NULL, or float32 (BH, S) for the row logsumexp.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      const void* cos, const void* sin, void* out, void* lse,
                                      int BH, int S, int d, void* stream) {
  if (BH <= 0 || S <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  if ((cos == nullptr) != (sin == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float *cs = (const float*)cos, *sn = (const float*)sin;
  float* l = (float*)lse;
  if (dtype == F32) return (int)launch_t<float>(d, q, k, v, cs, sn, out, l, BH, S, s);
  if (dtype == BF16) return (int)launch_t<__nv_bfloat16>(d, q, k, v, cs, sn, out, l, BH, S, s);
  return (int)cudaErrorInvalidValue;
}
