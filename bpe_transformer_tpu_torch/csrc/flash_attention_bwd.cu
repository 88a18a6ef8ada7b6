// Flash-attention backward (FlashAttention-2), causal or not: dK/dV and dQ.
//
// Replaces: bpe_transformer_tpu/kernels/pallas/flash_attention.py
//   _flash_bwd_impl (line 379): _flash_bwd_dkdv_kernel (line 299, pallas_call
//   at 418) and _flash_bwd_dq_kernel (line 341, pallas_call at 442), reached
//   from the causal flash VJP and from flash_attention_block_bwd (line 527),
//   which the ring-flash backward calls with causal=False for every
//   off-diagonal K/V shard, given the GLOBAL out and lse.
// Computes, per (batch*head), from the forward's q/k/v (BH, S, D), the
//   upstream gradient dO (BH, S, D), the forward's row logsumexp lse (BH, S)
//   and delta = rowsum(dO * O) (BH, S), both float32:
//     P  = exp(q k^T * scale - lse)     (causal or not; recomputed, never stored)
//     dV = P^T dO        dS = P * (dO V^T - delta)
//     dK = dS^T q * scale               dQ = dS K * scale
//   dq/dk/dv in the input type, accumulated in float32.  scale = 1/sqrt(d)
//   of the caller's true head dim d <= W (the wrapper zero-pads d to the
//   launch width W).
//
// Bound on the H100: operations at training lengths (about 2.5x the
// forward's flops: 5 products of 2 * d flops per unmasked (query, key) pair
// against 8 * S * d elements moved), bytes only at short S.  It runs its
// products on the CUDA cores in float32, well above the bound; its
// tensor-core redesign is queued (ROADMAP.md, queue B's redesign order).
//
// Design: the TPU runs two grids whose innermost axis is sequential and keeps
// the accumulators in VMEM scratch across it.  Blocks here run in parallel and
// in no order, so each kernel loops inside the block over the axis the TPU
// walks:
//   * dK/dV: one block per (BR-key tile, batch*head).  Each key row belongs to
//     TPR = max(1, D / 16) neighbouring threads holding D / TPR interleaved
//     columns of k, v and the float32 dK/dV accumulators in registers.  The
//     block walks BT-query tiles, staging q (scaled), dO, lse and delta in
//     shared memory: causal, from the tile that holds its first key (the
//     diagonal) to the end of the sequence, so tiles wholly above the
//     diagonal are never read; non-causal, every tile.
//   * dQ: one block per (BR-query tile, batch*head), each query row holding q,
//     dO and the dQ accumulator in registers, walking BT-key tiles of K and V
//     staged in shared memory: causal, from 0 up to the tile's last row;
//     non-causal, to the end.
// BR = 64 and BT = 32 up to D = 128; at D = 256, BR = 32 (512 threads) and
// BT = 16 (the two staged tiles stay within 48 KB of static shared memory).
// Widths W above 256 (any d_head; the wrapper pads to a multiple of 256) run
// at register width D = 256 with the W / 256 output-column chunks on
// gridDim.z, so registers do not grow with W: each block computes the
// full-width scores and dP by staging its tile in 256-column chunks (its own
// chunk last, so that chunk is what the gradient update then reads) with the
// owned rows' chunk reloaded into registers for each, and writes only its
// own columns of dk/dv or dq.  The scores are recomputed once per chunk,
// which is acceptable off the main path (no preset has a head dim above 128).
// Each gradient is owned by exactly one block, so no atomics are used and the
// results are the same from run to run (the TPU's two-kernel split gives the
// same property).  A ragged S is masked, not padded; rows past S are staged
// as zeros and skipped.

#include "common.cuh"

using namespace port;

namespace {

template <int D> struct Split {
  static constexpr int BR = D <= 128 ? 64 : 32;     // rows (keys for dK/dV, queries for dQ) owned
  static constexpr int BT = D <= 128 ? 32 : 16;     // rows per staged shared-memory tile
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

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(Split<D>::NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int S, int W, float scale) {
  constexpr int TPR = Split<D>::TPR, DT = Split<D>::DT, NT = Split<D>::NT;
  constexpr int BR = Split<D>::BR, BT = Split<D>::BT;

  __shared__ float q_sh[BT][D];  // q * scale
  __shared__ float do_sh[BT][D];
  __shared__ float lse_sh[BT];
  __shared__ float delta_sh[BT];

  const int nch = W / D;     // output-column chunks (gridDim.z; 1 below width 256)
  const int z = blockIdx.z;  // this block's chunk
  const int k0 = blockIdx.x * BR;
  const size_t bh = blockIdx.y;
  const size_t base = bh * S * W;
  const int key = k0 + threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const bool key_live = key < S;

  float kr[DT], vr[DT], dk_acc[DT], dv_acc[DT];
  auto load_kv = [&](int cc) {
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const size_t g = base + (size_t)key * W + cc * D + c * TPR + sub;
      kr[c] = key_live ? to_f(k[g]) : 0.f;
      vr[c] = key_live ? to_f(v[g]) : 0.f;
    }
  };
  load_kv(z);
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    dk_acc[c] = 0.f;
    dv_acc[c] = 0.f;
  }

  // Causal: query rows below k0 see none of this block's keys.
  for (int q0 = CAUSAL ? (k0 / BT) * BT : 0; q0 < S; q0 += BT) {
    if constexpr (D < 256) {
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < BT * D; i += NT) {
        const int row = q0 + i / D, col = i % D;
        const bool ok = row < S;
        const size_t g = base + (size_t)row * W + col;
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
        const bool live = key_live && (!CAUSAL || row >= key) && row < S;
        const float p = live ? expf(s - lse_sh[i]) : 0.f;
        const float ds = p * (dp - delta_sh[i]);
#pragma unroll
        for (int c = 0; c < DT; ++c) {
          dv_acc[c] += p * do_sh[i][c * TPR + sub];
          dk_acc[c] += ds * q_sh[i][c * TPR + sub];
        }
      }
    } else {
      // Register width 256: the scores and dP over every chunk first, this
      // block's chunk staged last.
      float s[BT], dp[BT];
#pragma unroll
      for (int i = 0; i < BT; ++i) s[i] = dp[i] = 0.f;
      for (int t = 0; t < nch; ++t) {
        const int cc = (z + 1 + t) % nch;
        if (nch > 1) load_kv(cc);
        __syncthreads();  // the previous tile is consumed
        for (int i = threadIdx.x; i < BT * D; i += NT) {
          const int row = q0 + i / D, col = i % D;
          const bool ok = row < S;
          const size_t g = base + (size_t)row * W + cc * D + col;
          q_sh[i / D][col] = ok ? to_f(q[g]) * scale : 0.f;
          do_sh[i / D][col] = ok ? to_f(dout[g]) : 0.f;
        }
        if (t == 0) {
          for (int i = threadIdx.x; i < BT; i += NT) {
            const bool ok = q0 + i < S;
            lse_sh[i] = ok ? lse[bh * S + q0 + i] : 0.f;
            delta_sh[i] = ok ? delta[bh * S + q0 + i] : 0.f;
          }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < BT; ++i) {
#pragma unroll
          for (int c = 0; c < DT; ++c) {
            s[i] += kr[c] * q_sh[i][c * TPR + sub];
            dp[i] += vr[c] * do_sh[i][c * TPR + sub];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < BT; ++i) {
        const float si = row_sum<TPR>(s[i]), dpi = row_sum<TPR>(dp[i]);
        const int row = q0 + i;
        const bool live = key_live && (!CAUSAL || row >= key) && row < S;
        const float p = live ? expf(si - lse_sh[i]) : 0.f;
        const float ds = p * (dpi - delta_sh[i]);
#pragma unroll
        for (int c = 0; c < DT; ++c) {
          dv_acc[c] += p * do_sh[i][c * TPR + sub];
          dk_acc[c] += ds * q_sh[i][c * TPR + sub];
        }
      }
    }
  }
  if (key_live) {
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const size_t g = base + (size_t)key * W + z * D + c * TPR + sub;
      dk[g] = from_f<T>(dk_acc[c]);
      dv[g] = from_f<T>(dv_acc[c]);
    }
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(Split<D>::NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int W,
                    float scale) {
  constexpr int TPR = Split<D>::TPR, DT = Split<D>::DT, NT = Split<D>::NT;
  constexpr int BR = Split<D>::BR, BT = Split<D>::BT;

  __shared__ float k_sh[BT][D];
  __shared__ float v_sh[BT][D];

  const int nch = W / D;     // output-column chunks (gridDim.z; 1 below width 256)
  const int z = blockIdx.z;  // this block's chunk
  const int q0 = blockIdx.x * BR;
  const size_t bh = blockIdx.y;
  const size_t base = bh * S * W;
  const int row = q0 + threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const bool row_live = row < S;

  float qr[DT], dor[DT], dq_acc[DT];
  auto load_qdo = [&](int cc) {
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const size_t g = base + (size_t)row * W + cc * D + c * TPR + sub;
      qr[c] = row_live ? to_f(q[g]) * scale : 0.f;
      dor[c] = row_live ? to_f(dout[g]) : 0.f;
    }
  };
  load_qdo(z);
#pragma unroll
  for (int c = 0; c < DT; ++c) dq_acc[c] = 0.f;
  const float lse_r = row_live ? lse[bh * S + row] : 0.f;
  const float delta_r = row_live ? delta[bh * S + row] : 0.f;

  // Causal: nothing past the tile's last row.
  const int last_key = CAUSAL ? min(q0 + BR, S) - 1 : S - 1;
  for (int k0 = 0; k0 <= last_key; k0 += BT) {
    if constexpr (D < 256) {
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < BT * D; i += NT) {
        const int kk = k0 + i / D, col = i % D;
        const bool ok = kk < S;
        const size_t g = base + (size_t)kk * W + col;
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
        const bool live = row_live && (!CAUSAL || key <= row) && key < S;
        const float p = live ? expf(s - lse_r) : 0.f;
        const float ds = p * (dp - delta_r);
#pragma unroll
        for (int c = 0; c < DT; ++c) dq_acc[c] += ds * k_sh[j][c * TPR + sub];
      }
    } else {
      // Register width 256: the scores and dP over every chunk first, this
      // block's chunk staged last.
      float s[BT], dp[BT];
#pragma unroll
      for (int j = 0; j < BT; ++j) s[j] = dp[j] = 0.f;
      for (int t = 0; t < nch; ++t) {
        const int cc = (z + 1 + t) % nch;
        if (nch > 1) load_qdo(cc);
        __syncthreads();  // the previous tile is consumed
        for (int i = threadIdx.x; i < BT * D; i += NT) {
          const int kk = k0 + i / D, col = i % D;
          const bool ok = kk < S;
          const size_t g = base + (size_t)kk * W + cc * D + col;
          k_sh[i / D][col] = ok ? to_f(k[g]) : 0.f;
          v_sh[i / D][col] = ok ? to_f(v[g]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < BT; ++j) {
#pragma unroll
          for (int c = 0; c < DT; ++c) {
            s[j] += qr[c] * k_sh[j][c * TPR + sub];
            dp[j] += dor[c] * v_sh[j][c * TPR + sub];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < BT; ++j) {
        const float sj = row_sum<TPR>(s[j]), dpj = row_sum<TPR>(dp[j]);
        const int key = k0 + j;
        const bool live = row_live && (!CAUSAL || key <= row) && key < S;
        const float p = live ? expf(sj - lse_r) : 0.f;
        const float ds = p * (dpj - delta_r);
#pragma unroll
        for (int c = 0; c < DT; ++c) dq_acc[c] += ds * k_sh[j][c * TPR + sub];
      }
    }
  }
  if (row_live) {
#pragma unroll
    for (int c = 0; c < DT; ++c)
      dq[base + (size_t)row * W + z * D + c * TPR + sub] = from_f<T>(dq_acc[c] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *g0, *g1;  // dk, dv (dK/dV kernel) or dq, unused (dQ kernel)
  int BH, S, W, d_true;
  bool causal;
};

template <typename T, int D, bool DKDV>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.S + Split<D>::BR - 1) / Split<D>::BR, a.BH, a.W / D),
      block(Split<D>::NT);
  const float scale = 1.0f / sqrtf((float)a.d_true);
  const T *q = (const T*)a.q, *k = (const T*)a.k, *v = (const T*)a.v, *o = (const T*)a.dout;
  if constexpr (DKDV) {
    if (a.causal) {
      flash_bwd_dkdv_kernel<T, D, true><<<grid, block, 0, stream>>>(
          q, k, v, o, a.lse, a.delta, (T*)a.g0, (T*)a.g1, a.S, a.W, scale);
    } else {
      flash_bwd_dkdv_kernel<T, D, false><<<grid, block, 0, stream>>>(
          q, k, v, o, a.lse, a.delta, (T*)a.g0, (T*)a.g1, a.S, a.W, scale);
    }
  } else {
    if (a.causal) {
      flash_bwd_dq_kernel<T, D, true><<<grid, block, 0, stream>>>(
          q, k, v, o, a.lse, a.delta, (T*)a.g0, a.S, a.W, scale);
    } else {
      flash_bwd_dq_kernel<T, D, false><<<grid, block, 0, stream>>>(
          q, k, v, o, a.lse, a.delta, (T*)a.g0, a.S, a.W, scale);
    }
  }
  return cudaGetLastError();
}

template <typename T, bool DKDV>
cudaError_t launch_t(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch_d<T, 16, DKDV>(a, s);
    case 32: return launch_d<T, 32, DKDV>(a, s);
    case 64: return launch_d<T, 64, DKDV>(a, s);
    case 128: return launch_d<T, 128, DKDV>(a, s);
    case 256: return launch_d<T, 256, DKDV>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKDV>
int launch(int dtype, const Args& a, void* stream) {
  if (a.BH <= 0 || a.S <= 0 || a.BH > 65535 || a.d_true <= 0 || a.d_true > a.W ||
      (a.W > 256 && a.W % 256))
    return (int)cudaErrorInvalidValue;
  const int D = a.W > 256 ? 256 : a.W;  // register width
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32) return (int)launch_t<float, DKDV>(D, a, s);
  if (dtype == BF16) return (int)launch_t<__nv_bfloat16, DKDV>(D, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k/v/dout/dk/dv (BH, S, W) contiguous, one dtype; lse/delta float32
// (BH, S).  W in {16, 32, 64, 128, 256} or any multiple of 256, the padded
// width of the true head dim d_true <= W (columns past d_true are zero).
// causal: 1 for the causal mask, 0 for none.
extern "C" int flash_attention_bwd_dkdv_launch(int dtype, const void* q, const void* k,
                                               const void* v, const void* dout, const void* lse,
                                               const void* delta, void* dk, void* dv, int BH,
                                               int S, int W, int d_true, int causal,
                                               void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)delta, dk, dv, BH, S, W, d_true,
               causal != 0};
  return launch<true>(dtype, a, stream);
}

// As above; writes dq (BH, S, W).
extern "C" int flash_attention_bwd_dq_launch(int dtype, const void* q, const void* k,
                                             const void* v, const void* dout, const void* lse,
                                             const void* delta, void* dq, int BH, int S, int W,
                                             int d_true, int causal, void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)delta, dq, nullptr, BH, S, W,
               d_true, causal != 0};
  return launch<false>(dtype, a, stream);
}
