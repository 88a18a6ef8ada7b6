// Flash-attention forward, causal or not, optionally with the row logsumexp
// and with RoPE applied to Q/K inside the kernel.
//
// Replaces: bpe_transformer_tpu/kernels/pallas/flash_attention.py
//   flash_attention (line 462) -> _flash_impl (line 164; kernel _flash_kernel
//   at 70, pallas_call at 264): the causal forward prefill calls (no lse), the
//   training forward (return_lse=True; lse store at 146-151),
//   flash_attention_with_rope (line 569; in-kernel rotation at 76-116), and
//   flash_attention_with_lse (line 512), which the ring-flash schedules call
//   with causal=False for every off-diagonal K/V shard.
// Computes: out = softmax(q k^T * scale [+ causal mask]) v per (batch*head),
//   q/k/v/out (BH, S, D), with online softmax: no (S, S) matrix is stored.
//   scale = 1/sqrt(d) of the caller's true head dim d <= D: the wrapper
//   zero-pads a d between the instantiated widths up to the next one, and
//   the zero columns add nothing to any score or output.
//   lse (BH, S) float32, when asked for, is m + log(l) per query row in units
//   of the scaled scores, the statistic the FA-2 backward recomputes P from
//   and the ring merges partial outputs by.
//   With cos/sin (S, D/2) float32 tables (rows gathered at the token
//   positions), q and k are first rotated pair by pair:
//   (x_e, x_o) -> (x_e c - x_o s, x_e s + x_o c).  Pairs are interleaved
//   (columns 2i, 2i+1 use table column i), so padding whole pairs at the end
//   of d leaves every true pair on its own table column.
//
// Bound on the H100: operations at long sequences (4 * d * S^2 / 2 flops per
// head causal, 4 * d * S^2 non-causal, against 4 * S * d elements moved),
// bytes at short ones.  This first kernel runs its products on the CUDA cores
// in float32, not on the tensor cores, so it sits well above the bound: wgmma
// tiles are later work.
//
// Design: one block per (64-query tile, batch*head).  The TPU's sequential key
// grid becomes a loop over BK-key tiles (32, or 16 at D = 256 so that the two
// tiles stay within 48 KB of static shared memory) that the block stages in
// shared memory (as float32) and that every query row of the tile reuses.
// Causal, the loop stops at the tile's last row, so keys above the diagonal
// are neither loaded nor computed; non-causal, it visits every key tile.  A
// ragged S is masked, not padded (the TPU pads S to its block and d to 128
// lanes).  Each query row belongs to TPR = max(1, D / 32)
// neighbouring threads of one warp, each holding D / TPR interleaved columns
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

// Keys per shared-memory tile: the K and V tiles take 2 * BK * D * 4 bytes.
template <int D> struct KeyTile { static constexpr int BK = D <= 128 ? 32 : 16; };

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

template <typename T, int D, bool ROPE, bool CAUSAL>
__global__ void __launch_bounds__(BQ * (D <= 32 ? 1 : D / 32))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                 T* __restrict__ out, float* __restrict__ lse, int S, float scale) {
  constexpr int TPR = D <= 32 ? 1 : D / 32;  // threads per query row
  constexpr int DT = D / TPR;                // columns per thread
  constexpr int NT = BQ * TPR;
  constexpr int H = D / 2;
  constexpr int BK = KeyTile<D>::BK;

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

  // Causal: nothing past the tile's last row.
  const int last_key = CAUSAL ? min(q0 + BQ, S) - 1 : S - 1;
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
      s[j] = ((!CAUSAL || key <= row) && key < S) ? part : MASK;
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
                     void* out, float* lse, int BH, int S, int d_true, bool causal,
                     cudaStream_t stream) {
  constexpr int TPR = D <= 32 ? 1 : D / 32;
  const dim3 grid((S + BQ - 1) / BQ, BH), block(BQ * TPR);
  const float scale = 1.0f / sqrtf((float)d_true);
  const T *qp = (const T*)q, *kp = (const T*)k, *vp = (const T*)v;
  if (cs != nullptr) {  // RoPE: the causal training and prefill forward only
    if (!causal) return cudaErrorInvalidValue;
    flash_fwd_kernel<T, D, true, true><<<grid, block, 0, stream>>>(
        qp, kp, vp, cs, sn, (T*)out, lse, S, scale);
  } else if (causal) {
    flash_fwd_kernel<T, D, false, true><<<grid, block, 0, stream>>>(
        qp, kp, vp, nullptr, nullptr, (T*)out, lse, S, scale);
  } else {
    flash_fwd_kernel<T, D, false, false><<<grid, block, 0, stream>>>(
        qp, kp, vp, nullptr, nullptr, (T*)out, lse, S, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int D, const void* q, const void* k, const void* v, const float* cs,
                     const float* sn, void* out, float* lse, int BH, int S, int d_true,
                     bool causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, cs, sn, out, lse, BH, S, d_true, causal, stream);
    case 32: return launch_d<T, 32>(q, k, v, cs, sn, out, lse, BH, S, d_true, causal, stream);
    case 64: return launch_d<T, 64>(q, k, v, cs, sn, out, lse, BH, S, d_true, causal, stream);
    case 128: return launch_d<T, 128>(q, k, v, cs, sn, out, lse, BH, S, d_true, causal, stream);
    case 256: return launch_d<T, 256>(q, k, v, cs, sn, out, lse, BH, S, d_true, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/out (BH, S, D), contiguous; D in {16, 32, 64, 128, 256}, the padded
// width of the true head dim d_true <= D (columns past d_true are zero).
// causal: 1 for the causal mask, 0 for none.  cos/sin: NULL, or float32
// (S, D/2) tables for RoPE in the kernel (both or neither; causal only).
// lse: NULL, or float32 (BH, S) for the row logsumexp.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      const void* cos, const void* sin, void* out, void* lse,
                                      int BH, int S, int D, int d_true, int causal,
                                      void* stream) {
  if (BH <= 0 || S <= 0 || BH > 65535 || d_true <= 0 || d_true > D)
    return (int)cudaErrorInvalidValue;
  if ((cos == nullptr) != (sin == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float *cs = (const float*)cos, *sn = (const float*)sin;
  float* l = (float*)lse;
  const bool c = causal != 0;
  if (dtype == F32) return (int)launch_t<float>(D, q, k, v, cs, sn, out, l, BH, S, d_true, c, s);
  if (dtype == BF16)
    return (int)launch_t<__nv_bfloat16>(D, q, k, v, cs, sn, out, l, BH, S, d_true, c, s);
  return (int)cudaErrorInvalidValue;
}
