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
// Bound on the H100: operations at training lengths (products of 2 d flops
// per unmasked (query, key) pair, four in dK/dV and three in dQ, against
// 6 S d and 5 S d elements moved: at (8, 12, 1024, 64) causal that is 25.8
// and 19.4 GFLOP, 0.026 and 0.020 ms at the bf16 tensor-core rate);
// bytes only at short S (the ring's 256-row shards: 0.023 and 0.019 ms).
//
// Two designs, by input type and width (kernels/flash_attention.py
// backward_width and backward_path):
//
// * bf16 at widths 64 and 128 (the wrapper pads a narrower head to 64):
//   the products run on the tensor cores.  The TPU's two grids, whose
//   innermost axis is sequential with the accumulators in VMEM scratch,
//   become two kernels whose blocks loop over that axis themselves; each
//   gradient is written by exactly one block, with no atomics, so a bf16
//   backward repeats bit for bit from call to call.
//   - dK/dV: one block per (128 keys, batch*head), two consumer warpgroups
//     of 64 keys each.  K and V are loaded once by TMA (3-D tensor maps over
//     (W, S, BH), 128-byte swizzle, 64-column sub-tiles).  The block walks
//     64-query tiles of Q and dO through a two-stage TMA ring, with the
//     tile's lse and delta (one bulk copy each) staged beside them.  Per
//     tile and warpgroup: S^T = K Q^T and dP^T = V dO^T (m64n64k16 wgmmas,
//     both operands K-major from shared memory); P^T = exp2(S^T scale log2e
//     - lse log2e) with the hardware's ex2, the causal mask only on the
//     diagonal tile; dS^T = P^T (dP^T - delta).  A query's lse and delta sit
//     on an accumulator column, so they are read from the staged copy by
//     column.  P^T and dS^T, rounded to bf16, are the register A operands of
//     dV += P^T dO and dK += dS^T Q, whose B operands (the staged dO and Q
//     tiles, queries x W) are read MN-major; dK is scaled once at the end.
//     Causal: the walk starts at the block's diagonal tile, and a warpgroup
//     skips the tile below its own keys.
//   - dQ: one block per (128 queries, batch*head), two warpgroups of 64
//     queries (Q and dO loaded once, each row's lse and delta in registers),
//     walking 64-key tiles of K and V through a two-stage TMA ring: S = Q
//     K^T, dP = dO V^T, P and dS as above (keys past S and, causal, above
//     the diagonal masked on edge tiles only), dQ += dS K with K read
//     MN-major.  Causal: the walk ends at the block's last row (longest
//     blocks launched first) and a warpgroup skips tiles above its rows.
//   The departure from the TPU kernel, which multiplies float32 P and dS,
//   is the bf16 rounding of P and dS before their products (about 2^-9 of
//   each term, as in the forward's P V); chip_smoke.py holds the gradients
//   to the bf16 tolerance.  The wrapper pads each lse/delta row to whole
//   64-query tiles when S is ragged (lse with 1e30, so a padded query's P
//   is exactly 0); rows past S are zeros from TMA and are never written.
//   Registers: a thread holds 64 D / 64 float32 accumulators of dK and of
//   dV; at width 256 they alone would take 256 registers, so width 256
//   stays on the CUDA cores.
// * float32 at every width (TINYSTORIES_4L trains in float32 and must keep
//   float32 accuracy: TF32 would not), and bf16 above width 128: the CUDA
//   cores, products in float32.
//   - dK/dV: one block per (BR-key tile, batch*head).  Each key row belongs
//     to TPR = max(1, D / 16) neighbouring threads holding D / TPR
//     interleaved columns of k, v and the float32 dK/dV accumulators in
//     registers.  The block walks BT-query tiles, staging q (scaled), dO,
//     lse and delta in shared memory: causal, from the tile that holds its
//     first key (the diagonal) to the end of the sequence, so tiles wholly
//     above the diagonal are never read; non-causal, every tile.
//   - dQ: one block per (BR-query tile, batch*head), each query row holding
//     q, dO and the dQ accumulator in registers, walking BT-key tiles of K
//     and V staged in shared memory: causal, from 0 up to the tile's last
//     row; non-causal, to the end.
//   BR = 64 and BT = 32 up to D = 128; at D = 256, BR = 32 (512 threads) and
//   BT = 16 (the two staged tiles stay within 48 KB of static shared
//   memory).  Widths W above 256 (any d_head; the wrapper pads to a multiple
//   of 256) run at register width D = 256 with the W / 256 output-column
//   chunks on gridDim.z, so registers do not grow with W: each block
//   computes the full-width scores and dP by staging its tile in 256-column
//   chunks (its own chunk last, so that chunk is what the gradient update
//   then reads) with the owned rows' chunk reloaded into registers for
//   each, and writes only its own columns of dk/dv or dq.  The scores are
//   recomputed once per chunk, which is acceptable off the main path (no
//   preset has a head dim above 128).  Each gradient is owned by exactly one
//   block here too.  A ragged S is masked, not padded; rows past S are
//   staged as zeros and skipped.

#include "common.cuh"
#include "hopper.cuh"

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
                      int S, int W, int LS, float scale) {
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
        lse_sh[i] = ok ? lse[bh * LS + q0 + i] : 0.f;
        delta_sh[i] = ok ? delta[bh * LS + q0 + i] : 0.f;
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
            lse_sh[i] = ok ? lse[bh * LS + q0 + i] : 0.f;
            delta_sh[i] = ok ? delta[bh * LS + q0 + i] : 0.f;
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
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int W, int LS,
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
  const float lse_r = row_live ? lse[bh * LS + row] : 0.f;
  const float delta_r = row_live ? delta[bh * LS + row] : 0.f;

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
  int BH, S, W, d_true, LS;  // LS: the row stride of lse and delta
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
          q, k, v, o, a.lse, a.delta, (T*)a.g0, (T*)a.g1, a.S, a.W, a.LS, scale);
    } else {
      flash_bwd_dkdv_kernel<T, D, false><<<grid, block, 0, stream>>>(
          q, k, v, o, a.lse, a.delta, (T*)a.g0, (T*)a.g1, a.S, a.W, a.LS, scale);
    }
  } else {
    if (a.causal) {
      flash_bwd_dq_kernel<T, D, true><<<grid, block, 0, stream>>>(
          q, k, v, o, a.lse, a.delta, (T*)a.g0, a.S, a.W, a.LS, scale);
    } else {
      flash_bwd_dq_kernel<T, D, false><<<grid, block, 0, stream>>>(
          q, k, v, o, a.lse, a.delta, (T*)a.g0, a.S, a.W, a.LS, scale);
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


// ----------------------------------------------------------- tensor cores

namespace tc {

using namespace port::sm90;

constexpr int STAGES = 2;
constexpr int NW = 2;        // consumer warpgroups a block
constexpr int NT = 128 * NW;
constexpr int BR = 64 * NW;  // rows a block owns: keys (dK/dV) or queries (dQ)
constexpr int BT = 64;       // rows of a streamed tile: queries (dK/dV) or keys (dQ)
constexpr float LOG2E = 1.4426950408889634f;

template <int D> struct Geo {
  static constexpr int NSUB = D / 64;            // 64-column sub-tiles
  static constexpr int OWN = BR * D * 2;         // one owned tile
  static constexpr int TILE = BT * D * 2;        // one streamed tile
  static constexpr int A_OFF = 0;                // K (dK/dV) or Q (dQ)
  static constexpr int B_OFF = OWN;              // V (dK/dV) or dO (dQ)
  static constexpr int ST_OFF = 2 * OWN;         // stages: Q, dO (dK/dV) or K, V (dQ)
  static constexpr int STAGE = 2 * TILE;
  static constexpr int STAT_OFF = ST_OFF + STAGES * STAGE;  // dK/dV: lse, delta a stage
  static constexpr int STAT = 2 * BT * 4;
  static constexpr int BAR_OFF = STAT_OFF + STAGES * STAT;
  static constexpr int BYTES = BAR_OFF + (1 + STAGES) * 8 + 1024;  // + slack to align
};

// `rows` rows from r0 of head bh of a (W, S, BH) map into dst, as 64-column
// sub-tiles of `rows` x 128 bytes one after the other.
template <int NSUB>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int rows, int r0, int bh) {
#pragma unroll
  for (int j = 0; j < NSUB; ++j) tma_load_3d(dst + j * rows * 128, map, bar, 64 * j, r0, bh);
}

// D (64 x 64) = A B^T over the head dim: A the warpgroup's 64 rows of an
// owned tile (BR rows a sub-tile), B a streamed tile (BT rows a sub-tile),
// both K-major.
template <int NSUB>
__device__ __forceinline__ void mma_rows(float (&d)[32], const uint8_t* own, int wg,
                                         const uint8_t* tile) {
#pragma unroll
  for (int kk = 0; kk < NSUB * 4; ++kk) {
    const int step = kk % 4 * 2;  // 32 bytes along the swizzled row
    wgmma_64_ss(d, desc_sw128(own + kk / 4 * BR * 128 + wg * 64 * 128) + step,
                desc_sw128(tile + kk / 4 * BT * 128) + step, 1);
  }
}

// acc[jj] (64 x 64 columns jj) += F T: F a 64 x BT bf16 fragment in
// registers, T a streamed BT-row tile read MN-major.
template <int NSUB>
__device__ __forceinline__ void mma_frag(float (&acc)[NSUB][32], const uint32_t (&f)[BT / 16][4],
                                         const uint8_t* tile) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
#pragma unroll
    for (int jj = 0; jj < NSUB; ++jj)
      wgmma_64_rs_mn(acc[jj], f[kk], desc_sw128(tile + jj * BT * 128 + kk * 16 * 128));
  }
}

__device__ __forceinline__ void pack_frags(uint32_t (&f)[BT / 16][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
  }
}

// Rows row and row + 8 (columns of sub-tile jj) of a float32 64 x D
// fragment, times `mul`, rounded to bf16 into out (BH, S, D) at head bh.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 64][32],
                                           size_t bh, int S, int row, int lane, float mul) {
#pragma unroll
  for (int jj = 0; jj < D / 64; ++jj) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = jj * 64 + 8 * n + 2 * (lane % 4);
      if (row < S)
        *reinterpret_cast<__nv_bfloat162*>(out + (bh * S + row) * D + col) =
            __floats2bfloat162_rn(acc[jj][4 * n] * mul, acc[jj][4 * n + 1] * mul);
      if (row + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(out + (bh * S + row + 8) * D + col) =
            __floats2bfloat162_rn(acc[jj][4 * n + 2] * mul, acc[jj][4 * n + 3] * mul);
    }
  }
}

// dK/dV: one block per (BR keys, batch*head); warpgroup wg owns keys
// kw0 = k0 + 64 wg .. + 63 and walks the query tiles with a transposed
// view: S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T land in the
// accumulator layout that is the register A operand of dV += P^T dO and
// dK += dS^T Q.  A query's lse and delta sit on an accumulator column,
// read from the stage's staged copy.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NT, 1)
bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int S, int LS, float scale) {
  using G = Geo<D>;
  constexpr int NSUB = G::NSUB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + G::BAR_OFF);  // [0] K/V, [1 + st] stage
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BR;  // causal: the first blocks have the most query tiles
  const int bh = blockIdx.y;
  const int kw0 = k0 + wg * 64;
  const int j0 = CAUSAL ? k0 / BT : 0;  // causal: query tiles below k0 see none of these keys
  const int n_tiles = (S + BT - 1) / BT - j0;

  auto load_stage = [&](int st, int j) {
    uint64_t* bar = &bars[1 + st];
    uint8_t* t = sm + G::ST_OFF + st * G::STAGE;
    float* stat = reinterpret_cast<float*>(sm + G::STAT_OFF + st * G::STAT);
    mbar_expect_tx(bar, G::STAGE + G::STAT);
    load_rows<NSUB>(t, &tm_q, bar, BT, j * BT, bh);
    load_rows<NSUB>(t + G::TILE, &tm_do, bar, BT, j * BT, bh);
    bulk_load(stat, lse + (size_t)bh * LS + j * BT, BT * 4, bar);
    bulk_load(stat + BT, delta + (size_t)bh * LS + j * BT, BT * 4, bar);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * G::OWN);
    load_rows<NSUB>(sm + G::A_OFF, &tm_k, &bars[0], BR, k0, bh);
    load_rows<NSUB>(sm + G::B_OFF, &tm_v, &bars[0], BR, k0, bh);
    for (int st = 0; st < STAGES && st < n_tiles; ++st) load_stage(st, j0 + st);
  }

  float dkr[NSUB][32], dvr[NSUB][32];
#pragma unroll
  for (int jj = 0; jj < NSUB; ++jj) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dkr[jj][i] = dvr[jj][i] = 0.f;
  }
  const float sl2 = scale * LOG2E;
  const int key_a = kw0 + warp * 16 + lane / 4;  // this thread's keys: key_a, key_a + 8
  mbar_wait(&bars[0], 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const int q0 = (j0 + it) * BT;
    mbar_wait(&bars[1 + st], (it / STAGES) & 1);
    const uint8_t* qt = sm + G::ST_OFF + st * G::STAGE;
    const uint8_t* dot = qt + G::TILE;
    const float* lse_t = reinterpret_cast<const float*>(sm + G::STAT_OFF + st * G::STAT);
    const float* delta_t = lse_t + BT;
    // Causal: tiles and key groups are 64-aligned, so a tile below kw0 is
    // wholly masked for this warpgroup and only q0 == kw0 crosses the diagonal.
    if (!CAUSAL || q0 >= kw0) {
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
      mma_rows<NSUB>(s, sm + G::A_OFF, wg, qt);
      mma_rows<NSUB>(dp, sm + G::B_OFF, wg, dot);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // s[4 n + e]: key key_a + 8 (e / 2), query q0 + 8 n + 2 (lane % 4) + e % 2.
      // Queries past S were staged with lse 1e30 (the wrapper's padding), so
      // their P is exactly 0.
      const bool diag = CAUSAL && q0 == kw0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        float p = fast_exp2(fmaf(s[i], sl2, -lse_t[qc] * LOG2E));
        if (diag && q0 + qc < key_a + 8 * ((i >> 1) & 1)) p = 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - delta_t[qc]);
      }
      uint32_t pf[BT / 16][4], df[BT / 16][4];
      pack_frags(pf, s);
      pack_frags(df, dp);
      wgmma_fence();
      mma_frag<NSUB>(dvr, pf, dot);
      mma_frag<NSUB>(dkr, df, qt);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int jj = 0; jj < NSUB; ++jj) {
        fence_regs(dvr[jj]);
        fence_regs(dkr[jj]);
      }
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        fence_regs(pf[kk]);
        fence_regs(df[kk]);
      }
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && it + STAGES < n_tiles) load_stage(st, j0 + it + STAGES);
  }
  store_rows<D>(dk, dkr, bh, S, key_a, lane, scale);
  store_rows<D>(dv, dvr, bh, S, key_a, lane, 1.f);
}

// dQ: one block per (BR queries, batch*head); warpgroup wg owns queries
// qw0 = q0 + 64 wg .. + 63 and walks the key tiles: S = Q K^T, dP = dO V^T,
// dQ += dS K with dS as the register A operand.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NT, 1)
bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                 const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S, int LS,
                 float scale) {
  using G = Geo<D>;
  constexpr int NSUB = G::NSUB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + G::BAR_OFF);  // [0] Q/dO, [1 + st] K/V
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  // Causal: the longest query tiles first, so the short ones fill the tail.
  const int q0 = (CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BR;
  const int bh = blockIdx.y;
  const int qw0 = q0 + wg * 64;
  const int n_tiles = ((CAUSAL ? min(q0 + BR, S) : S) + BT - 1) / BT;

  auto load_stage = [&](int st, int j) {
    uint64_t* bar = &bars[1 + st];
    uint8_t* t = sm + G::ST_OFF + st * G::STAGE;
    mbar_expect_tx(bar, G::STAGE);
    load_rows<NSUB>(t, &tm_k, bar, BT, j * BT, bh);
    load_rows<NSUB>(t + G::TILE, &tm_v, bar, BT, j * BT, bh);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * G::OWN);
    load_rows<NSUB>(sm + G::A_OFF, &tm_q, &bars[0], BR, q0, bh);
    load_rows<NSUB>(sm + G::B_OFF, &tm_do, &bars[0], BR, q0, bh);
    for (int st = 0; st < STAGES && st < n_tiles; ++st) load_stage(st, st);
  }

  float dqr[NSUB][32];
#pragma unroll
  for (int jj = 0; jj < NSUB; ++jj) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dqr[jj][i] = 0.f;
  }
  const float sl2 = scale * LOG2E;
  const int row_a = qw0 + warp * 16 + lane / 4;  // this thread's queries: row_a, row_a + 8
  const size_t srow = (size_t)bh * LS;
  // Rows past S hold zeros; their P is forced to 0 by a huge lse.
  const float l2a = row_a < S ? lse[srow + row_a] * LOG2E : 1e30f;
  const float l2b = row_a + 8 < S ? lse[srow + row_a + 8] * LOG2E : 1e30f;
  const float dla = row_a < S ? delta[srow + row_a] : 0.f;
  const float dlb = row_a + 8 < S ? delta[srow + row_a + 8] : 0.f;
  mbar_wait(&bars[0], 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const int kt0 = it * BT;
    mbar_wait(&bars[1 + st], (it / STAGES) & 1);
    const uint8_t* kt = sm + G::ST_OFF + st * G::STAGE;
    const uint8_t* vt = kt + G::TILE;
    // Causal: a key tile above this warpgroup's rows adds nothing to them.
    if (!CAUSAL || kt0 <= qw0) {
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
      mma_rows<NSUB>(s, sm + G::A_OFF, wg, kt);
      mma_rows<NSUB>(dp, sm + G::B_OFF, wg, vt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // s[4 n + e]: query row_a + 8 (e / 2), key kt0 + 8 n + 2 (lane % 4) + e % 2.
      const bool edge = kt0 + BT > S || (CAUSAL && kt0 == qw0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = (i >> 1) & 1;
        float p = fast_exp2(fmaf(s[i], sl2, -(hi ? l2b : l2a)));
        if (edge) {
          const int key = kt0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          if (key >= S || (CAUSAL && key > row_a + 8 * hi)) p = 0.f;
        }
        s[i] = p * (dp[i] - (hi ? dlb : dla));
      }
      uint32_t df[BT / 16][4];
      pack_frags(df, s);
      wgmma_fence();
      mma_frag<NSUB>(dqr, df, kt);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int jj = 0; jj < NSUB; ++jj) fence_regs(dqr[jj]);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) fence_regs(df[kk]);
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && it + STAGES < n_tiles) load_stage(st, it + STAGES);
  }
  store_rows<D>(dq, dqr, bh, S, row_a, lane, scale);
}

template <int D, bool DKDV, bool CAUSAL>
cudaError_t launch_kernel(const Args& a, cudaStream_t stream) {
  using G = Geo<D>;
  CUtensorMap tq, tk, tv, tdo;
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)a.S, (uint64_t)a.BH};
  const uint32_t own[2] = {64, BR}, streamed[2] = {64, BT};
  const uint32_t* box_qdo = DKDV ? streamed : own;
  const uint32_t* box_kv = DKDV ? own : streamed;
  if (!encode_bf16(&tq, a.q, 3, dims, box_qdo) || !encode_bf16(&tdo, a.dout, 3, dims, box_qdo) ||
      !encode_bf16(&tk, a.k, 3, dims, box_kv) || !encode_bf16(&tv, a.v, 3, dims, box_kv))
    return cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)a.d_true);
  const dim3 grid((a.S + BR - 1) / BR, a.BH);
  static int ready = -1;
  if constexpr (DKDV) {
    const cudaError_t err = allow_smem(bwd_dkdv_tc_kernel<D, CAUSAL>, G::BYTES, ready);
    if (err != cudaSuccess) return err;
    bwd_dkdv_tc_kernel<D, CAUSAL><<<grid, NT, G::BYTES, stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, (__nv_bfloat16*)a.g0, (__nv_bfloat16*)a.g1, a.S, a.LS,
        scale);
  } else {
    const cudaError_t err = allow_smem(bwd_dq_tc_kernel<D, CAUSAL>, G::BYTES, ready);
    if (err != cudaSuccess) return err;
    bwd_dq_tc_kernel<D, CAUSAL><<<grid, NT, G::BYTES, stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, (__nv_bfloat16*)a.g0, a.S, a.LS, scale);
  }
  return cudaGetLastError();
}

template <int D, bool DKDV>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  return a.causal ? launch_kernel<D, DKDV, true>(a, stream)
                  : launch_kernel<D, DKDV, false>(a, stream);
}

}  // namespace tc

template <bool DKDV>
int launch(int dtype, const Args& a, void* stream) {
  if (a.BH <= 0 || a.S <= 0 || a.BH > 65535 || a.d_true <= 0 || a.d_true > a.W ||
      (a.W > 256 && a.W % 256) || a.LS < a.S)
    return (int)cudaErrorInvalidValue;
  const int D = a.W > 256 ? 256 : a.W;  // register width
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == BF16 && (a.W == 64 || a.W == 128)) {
    // The tensor cores stage whole 64-query tiles of lse and delta.
    if (a.LS % tc::BT) return (int)cudaErrorInvalidValue;
    return (int)(a.W == 64 ? tc::launch_d<64, DKDV>(a, s) : tc::launch_d<128, DKDV>(a, s));
  }
  if (dtype == F32) return (int)launch_t<float, DKDV>(D, a, s);
  if (dtype == BF16) return (int)launch_t<__nv_bfloat16, DKDV>(D, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k/v/dout/dk/dv (BH, S, W) contiguous and 16-byte aligned, one dtype;
// lse/delta float32 (BH, LS), the first S of each row used, LS >= S.  W in
// {16, 32, 64, 128, 256} or any multiple of 256, the padded width of the
// true head dim d_true <= W (columns past d_true are zero).  bf16 at W 64
// and 128 runs on the tensor cores and needs LS a multiple of 64, with lse
// past S at 1e30 and delta past S finite.  causal: 1 for the causal mask, 0
// for none.
extern "C" int flash_attention_bwd_dkdv_launch(int dtype, const void* q, const void* k,
                                               const void* v, const void* dout, const void* lse,
                                               const void* delta, void* dk, void* dv, int BH,
                                               int S, int W, int d_true, int LS, int causal,
                                               void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)delta, dk, dv, BH, S, W, d_true,
               LS, causal != 0};
  return launch<true>(dtype, a, stream);
}

// As above; writes dq (BH, S, W).
extern "C" int flash_attention_bwd_dq_launch(int dtype, const void* q, const void* k,
                                             const void* v, const void* dout, const void* lse,
                                             const void* delta, void* dq, int BH, int S, int W,
                                             int d_true, int LS, int causal, void* stream) {
  const Args a{q, k, v, dout, (const float*)lse, (const float*)delta, dq, nullptr, BH, S, W,
               d_true, LS, causal != 0};
  return launch<false>(dtype, a, stream);
}
