// Causal flash-attention backward (FlashAttention-2): dK/dV and dQ.
//
// Replaces: bpe_transformer_tpu/kernels/pallas/flash_attention.py
//   _flash_bwd_impl (line 379): _flash_bwd_dkdv_kernel (line 299, pallas_call
//   at 418) and _flash_bwd_dq_kernel (line 341, pallas_call at 442).
// Computes, per (batch*head), from the forward's q/k/v (BH, S, d), the
//   upstream gradient dO (BH, S, d), the forward's row logsumexp lse (BH, S)
//   and delta = rowsum(dO * O) (BH, S), both float32:
//     P  = exp(q k^T / sqrt(d) - lse)   (causal; recomputed, never stored)
//     dV = P^T dO        dS = P * (dO V^T - delta)
//     dK = dS^T q / sqrt(d)             dQ = dS K / sqrt(d)
//   dq/dk/dv in the input type, accumulated in float32.
//
// Bound on the H100: operations at training lengths (about 2.5x the
// forward's flops: 5 products of 2 * d flops per unmasked (query, key) pair
// against 8 * S * d elements moved), bytes only at short S.  Like the forward
// it runs its products on the CUDA cores in float32, well above the bound;
// tensor-core tiles are later work.
//
// Design: the TPU runs two grids whose innermost axis is sequential and keeps
// the accumulators in VMEM scratch across it.  Blocks here run in parallel and
// in no order, so each kernel loops inside the block over the axis the TPU
// walks:
//   * dK/dV: one block per (64-key tile, batch*head).  Each key row belongs to
//     TPR = max(1, d / 16) neighbouring threads holding d / TPR interleaved
//     columns of k, v and the float32 dK/dV accumulators in registers.  The
//     block walks 32-query tiles from the one that holds its first key (the
//     diagonal) to the end of the sequence, staging q (scaled), dO, lse and
//     delta in shared memory; tiles wholly above the diagonal are never read.
//   * dQ: one block per (64-query tile, batch*head), each query row holding q,
//     dO and the dQ accumulator in registers, walking 32-key tiles of K and V
//     staged in shared memory from 0 up to the tile's last row.
// Each gradient is owned by exactly one block, so no atomics are used and the
// results are the same from run to run (the TPU's two-kernel split gives the
// same property).  A ragged S is masked, not padded; rows past S are staged
// as zeros and skipped.

#include "common.cuh"

using namespace port;

namespace {

constexpr int BR = 64;  // rows (keys for dK/dV, queries for dQ) owned per block
constexpr int BT = 32;  // rows per staged shared-memory tile

template <int D> struct Split {
  static constexpr int TPR = D <= 16 ? 1 : D / 16;  // threads per owned row
  static constexpr int DT = D / TPR;                // columns per thread
  static constexpr int NT = BR * TPR;               // threads per block
};

// Sum of `part` over the TPR neighbouring threads that share one row.
template <int TPR>
__device__ __forceinline__ float row_sum(float part) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  return part;
}

template <typename T, int D>
__global__ void __launch_bounds__(Split<D>::NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int S, float scale) {
  constexpr int TPR = Split<D>::TPR, DT = Split<D>::DT, NT = Split<D>::NT;

  __shared__ float q_sh[BT][D];  // q * scale
  __shared__ float do_sh[BT][D];
  __shared__ float lse_sh[BT];
  __shared__ float delta_sh[BT];

  const int k0 = blockIdx.x * BR;
  const size_t bh = blockIdx.y;
  const size_t base = bh * S * D;
  const int key = k0 + threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const bool key_live = key < S;

  float kr[DT], vr[DT], dk_acc[DT], dv_acc[DT];
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    const size_t g = base + (size_t)key * D + c * TPR + sub;
    kr[c] = key_live ? to_f(k[g]) : 0.f;
    vr[c] = key_live ? to_f(v[g]) : 0.f;
    dk_acc[c] = 0.f;
    dv_acc[c] = 0.f;
  }

  // Causal: query rows below k0 see none of this block's keys.
  for (int q0 = (k0 / BT) * BT; q0 < S; q0 += BT) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BT * D; i += NT) {
      const int row = q0 + i / D, col = i % D;
      const bool ok = row < S;
      const size_t g = base + (size_t)row * D + col;
      q_sh[i / D][col] = ok ? to_f(q[g]) * scale : 0.f;
      do_sh[i / D][col] = ok ? to_f(dout[g]) : 0.f;
    }
    for (int i = threadIdx.x; i < BT; i += NT) {
      const bool ok = q0 + i < S;
      lse_sh[i] = ok ? lse[bh * S + q0 + i] : 0.f;
      delta_sh[i] = ok ? delta[bh * S + q0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < BT; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        s += kr[c] * q_sh[i][c * TPR + sub];
        dp += vr[c] * do_sh[i][c * TPR + sub];
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const int row = q0 + i;
      const bool live = key_live && row >= key && row < S;
      const float p = live ? expf(s - lse_sh[i]) : 0.f;
      const float ds = p * (dp - delta_sh[i]);
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        dv_acc[c] += p * do_sh[i][c * TPR + sub];
        dk_acc[c] += ds * q_sh[i][c * TPR + sub];
      }
    }
  }
  if (key_live) {
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const size_t g = base + (size_t)key * D + c * TPR + sub;
      dk[g] = from_f<T>(dk_acc[c]);
      dv[g] = from_f<T>(dv_acc[c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Split<D>::NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, float scale) {
  constexpr int TPR = Split<D>::TPR, DT = Split<D>::DT, NT = Split<D>::NT;

  __shared__ float k_sh[BT][D];
  __shared__ float v_sh[BT][D];

  const int q0 = blockIdx.x * BR;
  const size_t bh = blockIdx.y;
  const size_t base = bh * S * D;
  const int row = q0 + threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const bool row_live = row < S;

  float qr[DT], dor[DT], dq_acc[DT];
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    const size_t g = base + (size_t)row * D + c * TPR + sub;
    qr[c] = row_live ? to_f(q[g]) * scale : 0.f;
    dor[c] = row_live ? to_f(dout[g]) : 0.f;
    dq_acc[c] = 0.f;
  }
  const float lse_r = row_live ? lse[bh * S + row] : 0.f;
  const float delta_r = row_live ? delta[bh * S + row] : 0.f;

  const int last_key = min(q0 + BR, S) - 1;  // causal: nothing past the tile's last row
  for (int k0 = 0; k0 <= last_key; k0 += BT) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BT * D; i += NT) {
      const int kk = k0 + i / D, col = i % D;
      const bool ok = kk < S;
      const size_t g = base + (size_t)kk * D + col;
      k_sh[i / D][col] = ok ? to_f(k[g]) : 0.f;
      v_sh[i / D][col] = ok ? to_f(v[g]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        s += qr[c] * k_sh[j][c * TPR + sub];
        dp += dor[c] * v_sh[j][c * TPR + sub];
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const int key = k0 + j;
      const bool live = row_live && key <= row && key < S;
      const float p = live ? expf(s - lse_r) : 0.f;
      const float ds = p * (dp - delta_r);
#pragma unroll
      for (int c = 0; c < DT; ++c) dq_acc[c] += ds * k_sh[j][c * TPR + sub];
    }
  }
  if (row_live) {
#pragma unroll
    for (int c = 0; c < DT; ++c)
      dq[base + (size_t)row * D + c * TPR + sub] = from_f<T>(dq_acc[c] * scale);
  }
}

template <typename T, int D>
cudaError_t launch_dkdv_d(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dk, void* dv, int BH, int S,
                          cudaStream_t stream) {
  const dim3 grid((S + BR - 1) / BR, BH), block(Split<D>::NT);
  flash_bwd_dkdv_kernel<T, D><<<grid, block, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, S,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_d(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, int BH, int S,
                        cudaStream_t stream) {
  const dim3 grid((S + BR - 1) / BR, BH), block(Split<D>::NT);
  flash_bwd_dq_kernel<T, D><<<grid, block, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, S,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkdv_t(int d, const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dk, void* dv, int BH, int S,
                          cudaStream_t s) {
  switch (d) {
    case 16: return launch_dkdv_d<T, 16>(q, k, v, dout, lse, delta, dk, dv, BH, S, s);
    case 32: return launch_dkdv_d<T, 32>(q, k, v, dout, lse, delta, dk, dv, BH, S, s);
    case 64: return launch_dkdv_d<T, 64>(q, k, v, dout, lse, delta, dk, dv, BH, S, s);
    case 128: return launch_dkdv_d<T, 128>(q, k, v, dout, lse, delta, dk, dv, BH, S, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dq_t(int d, const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, int BH, int S,
                        cudaStream_t s) {
  switch (d) {
    case 16: return launch_dq_d<T, 16>(q, k, v, dout, lse, delta, dq, BH, S, s);
    case 32: return launch_dq_d<T, 32>(q, k, v, dout, lse, delta, dq, BH, S, s);
    case 64: return launch_dq_d<T, 64>(q, k, v, dout, lse, delta, dq, BH, S, s);
    case 128: return launch_dq_d<T, 128>(q, k, v, dout, lse, delta, dq, BH, S, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/dout/dk/dv (BH, S, d) contiguous, one dtype; lse/delta float32
// (BH, S); causal; d in {16, 32, 64, 128}.
extern "C" int flash_attention_bwd_dkdv_launch(int dtype, const void* q, const void* k,
                                               const void* v, const void* dout, const void* lse,
                                               const void* delta, void* dk, void* dv, int BH,
                                               int S, int d, void* stream) {
  if (BH <= 0 || S <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float *l = (const float*)lse, *dl = (const float*)delta;
  if (dtype == F32) return (int)launch_dkdv_t<float>(d, q, k, v, dout, l, dl, dk, dv, BH, S, s);
  if (dtype == BF16)
    return (int)launch_dkdv_t<__nv_bfloat16>(d, q, k, v, dout, l, dl, dk, dv, BH, S, s);
  return (int)cudaErrorInvalidValue;
}

// As above; writes dq (BH, S, d).
extern "C" int flash_attention_bwd_dq_launch(int dtype, const void* q, const void* k,
                                             const void* v, const void* dout, const void* lse,
                                             const void* delta, void* dq, int BH, int S, int d,
                                             void* stream) {
  if (BH <= 0 || S <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float *l = (const float*)lse, *dl = (const float*)delta;
  if (dtype == F32) return (int)launch_dq_t<float>(d, q, k, v, dout, l, dl, dq, BH, S, s);
  if (dtype == BF16)
    return (int)launch_dq_t<__nv_bfloat16>(d, q, k, v, dout, l, dl, dq, BH, S, s);
  return (int)cudaErrorInvalidValue;
}
