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
//   q/k/v/out (BH, S, W), with online softmax: no (S, S) matrix is stored.
//   scale = 1/sqrt(d) of the caller's true head dim d <= W: the wrapper
//   zero-pads d up to the launch width W, and the zero columns add nothing
//   to any score or output.
//   lse (BH, S) float32, when asked for, is m + log(l) per query row in units
//   of the scaled scores, the statistic the FA-2 backward recomputes P from
//   and the ring merges partial outputs by.
//   With cos/sin (S, W/2) float32 tables (rows gathered at the token
//   positions), q and k are first rotated pair by pair:
//   (x_e, x_o) -> (x_e c - x_o s, x_e s + x_o c).  Pairs are interleaved
//   (columns 2i, 2i+1 use table column i), so padding whole pairs at the end
//   of d leaves every true pair on its own table column.
//
// Bound on the H100: operations at training lengths (4 d S^2 / 2 flops per
// head causal, 4 d S^2 non-causal, against 4 S d elements moved: at
// (8, 12, 1024, 64) causal that is 12.9 GFLOP, 0.013 ms at the bf16
// tensor-core rate, against 0.015 ms of bytes), bytes at short ones.
//
// Two designs, by input type:
//
// * bf16, widths 64, 128 and 256 (the wrapper pads a narrower head to 64):
//   the products run on the tensor cores, FA-2/FA-3 style.  One block per
//   (tile of BQ query rows, batch*head); each consumer warpgroup owns 64 of
//   the rows (two warpgroups, one for RoPE at width 256 where the tiles fill
//   shared memory).  The TPU's sequential key grid becomes a loop over BK-key
//   tiles (128 keys at width 128; 64 at width 256, and at width 64, where
//   the smaller tiles keep a block under 128 registers a thread and 72 KB of
//   shared memory, so two blocks share an SM and one's softmax overlaps the
//   other's products) that one thread loads with
//   TMA (3-D tensor maps over (W, S, BH), 128-byte swizzle, 64-column
//   sub-tiles; zeros past S) into a two-stage ring signalled by mbarriers,
//   while the block computes on the other stage; Q is loaded once.
//   S = Q K^T is a chain of m64nBKk16 wgmmas from shared memory (both
//   operands K-major), float32 in registers.  The online softmax runs on the
//   accumulator fragments (the hardware's ex2 of log2e-scaled scores, one
//   instruction where the accurate exp2f takes several; a row's statistics
//   live in the four threads that hold it).  P, rounded to bf16, is the
//   register A operand of O += P V, whose B operand V (keys x W, row-major)
//   is read MN-major (the transposed-B form), 64 output columns an
//   instruction; O stays float32 in registers (at most 128 a thread, width
//   256).  Causal: the block's key loop ends at its last row, a warpgroup
//   skips tiles wholly above its own rows, and only tiles that cross the
//   diagonal or S are masked.  The departure from the TPU kernel, which
//   multiplies float32 P by V, is the bf16 rounding of P: about 2^-9 of each
//   weight, within the bf16 output tolerance (chip_smoke.py measures it); l
//   sums the unrounded float32 P, so the lse is unaffected.
//   RoPE: each tile is rotated in shared memory after it lands (a thread per
//   16-byte chunk: the swizzle moves whole chunks, so every pair stays
//   together), then fenced for the async proxy.  A rotated value is not a
//   bf16 value, and one rounding would move the scores by ~1e-3 and the lse
//   far past its float32 tolerance; so each rotated tile is kept as a bf16
//   high part (in place) and a bf16 residual (a second buffer), and the
//   scores sum three products, hi hi + hi lo + lo hi (the dropped lo lo term
//   and the residual's own rounding are ~2^-16 of each product).
// * float32 at every width (TINYSTORIES_4L trains in float32 and must keep
//   float32 accuracy: TF32 would not), and bf16 above width 256: the CUDA
//   cores.  One block per (64-query tile, batch*head, output-column chunk).
//   The key loop stages BK-key tiles (32, or 16 at register width 256) of K
//   and V in shared memory as float32, reused by every query row of the
//   tile.  Each query row belongs to TPR = max(1, D / 32) neighbouring
//   threads of one warp, each holding D / TPR interleaved columns of q and of
//   the float32 accumulator in registers (D = min(W, 256)), the row's scores
//   summed across them with warp shuffles.  Causal, the loop stops at the
//   tile's last row.  RoPE rotates each element as it is loaded, reading its
//   pair partner (column ^ 1) from the same cached row.
//   Widths above 256 (any d_head; the wrapper pads to a multiple of 256):
//   the W / 256 output-column chunks run on gridDim.z, so registers do not
//   grow with W.  Each block computes the full-width scores by staging K in
//   256-column chunks (its own chunk last, together with that chunk of V),
//   q's chunk reloaded into registers for each, and writes only its own
//   columns of out; the block of chunk 0 writes the lse.  The scores are
//   recomputed once per chunk, which is acceptable off the main path (no
//   preset has a head dim above 128).
// A ragged S is masked, not padded (the TPU pads S to its block and d to 128
// lanes).  The lse is one float per row (the TPU writes 128 lane copies for
// its VMEM tiling).

#include "common.cuh"
#include "hopper.cuh"

using namespace port;

namespace {

// ------------------------------------------------------------ CUDA cores

constexpr int BQ = 64;  // query rows per block

// Keys per shared-memory tile: the K and V tiles take 2 * BK * D * 4 bytes.
template <int D> struct KeyTile { static constexpr int BK = D <= 128 ? 32 : 16; };

// Element `col` of row `row_ptr` after the interleaved-pair rotation by the
// table row `cs`/`sn`.
template <typename T>
__device__ __forceinline__ float rotated(const T* row_ptr, int col, const float* cs,
                                         const float* sn) {
  const float x = to_f(row_ptr[col]);
  const float partner = to_f(row_ptr[col ^ 1]);
  const float c = cs[col >> 1], s = sn[col >> 1];
  return (col & 1) ? partner * s + x * c : x * c - partner * s;
}

// This thread's DT columns (c * TPR + sub, from c0) of the query row, scaled.
template <typename T, int DT, int TPR, bool ROPE>
__device__ __forceinline__ void load_q(float (&qr)[DT], const T* qrow, const float* cs,
                                       const float* sn, int c0, int sub, bool live, float scale) {
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    const int col = c0 + c * TPR + sub;
    float x = 0.f;
    if (live) x = ROPE ? rotated(qrow, col, cs, sn) : to_f(qrow[col]);
    qr[c] = x * scale;
  }
}

template <typename T, int D, bool ROPE, bool CAUSAL>
__global__ void __launch_bounds__(BQ * (D <= 32 ? 1 : D / 32))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                 T* __restrict__ out, float* __restrict__ lse, int S, int W, float scale) {
  constexpr int TPR = D <= 32 ? 1 : D / 32;  // threads per query row
  constexpr int DT = D / TPR;                // columns per thread
  constexpr int NT = BQ * TPR;
  constexpr int BK = KeyTile<D>::BK;

  __shared__ float k_sh[BK][D];
  __shared__ float v_sh[BK][D];

  const int H = W / 2;          // table row length
  const int nch = W / D;        // output-column chunks (gridDim.z)
  const int z = blockIdx.z;     // this block's chunk
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * S * W;
  const int row = q0 + threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const bool row_live = row < S;
  const T* qrow = q + base + (size_t)row * W;
  const float* qcs = ROPE ? cos_t + (size_t)row * H : nullptr;
  const float* qsn = ROPE ? sin_t + (size_t)row * H : nullptr;

  float qr[DT], acc[DT];
  load_q<T, DT, TPR, ROPE>(qr, qrow, qcs, qsn, 0, sub, row_live, scale);
#pragma unroll
  for (int c = 0; c < DT; ++c) acc[c] = 0.f;
  float m = MASK, l = 0.f;

  // Causal: nothing past the tile's last row.
  const int last_key = CAUSAL ? min(q0 + BQ, S) - 1 : S - 1;
  for (int k0 = 0; k0 <= last_key; k0 += BK) {
    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) s[j] = 0.f;
    if (nch == 1) {  // one chunk: K and V staged together, q kept in registers
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < BK * D; i += NT) {
        const int kk = k0 + i / D, col = i % D;
        const bool ok = kk < S;
        const size_t g = base + (size_t)kk * W;
        float kv = 0.f;
        if (ok) {
          if constexpr (ROPE) {
            kv = rotated(k + g, col, cos_t + (size_t)kk * H, sin_t + (size_t)kk * H);
          } else {
            kv = to_f(k[g + col]);
          }
        }
        k_sh[i / D][col] = kv;
        v_sh[i / D][col] = ok ? to_f(v[g + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < BK; ++j) {
#pragma unroll
        for (int c = 0; c < DT; ++c) s[j] += qr[c] * k_sh[j][c * TPR + sub];
      }
    }
    // Chunk z comes last, so its V columns are staged with its K columns.
    for (int t = 0; nch > 1 && t < nch; ++t) {
      const int cc = (z + 1 + t) % nch;
      load_q<T, DT, TPR, ROPE>(qr, qrow, qcs, qsn, cc * D, sub, row_live, scale);
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < BK * D; i += NT) {
        const int kk = k0 + i / D, col = cc * D + i % D;
        const bool ok = kk < S;
        const T* krow = k + base + (size_t)kk * W;
        float kv = 0.f;
        if (ok) {
          if constexpr (ROPE) {
            kv = rotated(krow, col, cos_t + (size_t)kk * H, sin_t + (size_t)kk * H);
          } else {
            kv = to_f(krow[col]);
          }
        }
        k_sh[i / D][i % D] = kv;
        if (t == nch - 1) v_sh[i / D][i % D] = ok ? to_f(v[base + (size_t)kk * W + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < DT; ++c) part += qr[c] * k_sh[j][c * TPR + sub];
        s[j] += part;
      }
    }
    float mt = MASK;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = s[j];
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
    T* orow = out + base + (size_t)row * W + z * D;
#pragma unroll
    for (int c = 0; c < DT; ++c) orow[c * TPR + sub] = from_f<T>(acc[c] * inv);
    if (lse != nullptr && sub == 0 && z == 0) lse[(size_t)blockIdx.y * S + row] = m + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch_cores(const void* q, const void* k, const void* v, const float* cs,
                         const float* sn, void* out, float* lse, int BH, int S, int W,
                         float scale, bool causal, cudaStream_t stream) {
  constexpr int TPR = D <= 32 ? 1 : D / 32;
  const dim3 grid((S + BQ - 1) / BQ, BH, W / D), block(BQ * TPR);
  const T *qp = (const T*)q, *kp = (const T*)k, *vp = (const T*)v;
  if (cs != nullptr) {  // RoPE: the causal training and prefill forward only
    flash_fwd_kernel<T, D, true, true><<<grid, block, 0, stream>>>(
        qp, kp, vp, cs, sn, (T*)out, lse, S, W, scale);
  } else if (causal) {
    flash_fwd_kernel<T, D, false, true><<<grid, block, 0, stream>>>(
        qp, kp, vp, nullptr, nullptr, (T*)out, lse, S, W, scale);
  } else {
    flash_fwd_kernel<T, D, false, false><<<grid, block, 0, stream>>>(
        qp, kp, vp, nullptr, nullptr, (T*)out, lse, S, W, scale);
  }
  return cudaGetLastError();
}

// ----------------------------------------------------------- tensor cores

namespace tc {

using namespace port::sm90;

constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D, bool ROPE> struct Geo {
  static constexpr int NW = (ROPE && D == 256) ? 1 : 2;  // warpgroups of 64 query rows
  static constexpr int BQ = 64 * NW;
  static constexpr int NT = 128 * NW;
  static constexpr int BK = D == 128 ? 128 : 64;  // keys per tile
  static constexpr int NSUB = D / 64;             // 64-column sub-tiles
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int T_BYTES = BK * D * 2;      // one K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int QLO_OFF = Q_BYTES;         // RoPE: residual of the rotated Q
  static constexpr int K_OFF = Q_BYTES * (ROPE ? 2 : 1);
  static constexpr int V_OFF = K_OFF + STAGES * T_BYTES;
  static constexpr int KLO_OFF = V_OFF + STAGES * T_BYTES;  // RoPE: residual of K
  static constexpr int BAR_OFF = KLO_OFF + (ROPE ? T_BYTES : 0);
  static constexpr int BYTES = BAR_OFF + (1 + STAGES) * 8 + 1024;  // + slack to align
};

// Rotate the interleaved pairs of a ROWS x (64 NSUB) tile (64-column
// sub-tiles, 128-byte swizzle) whose row r holds position p0 + r: the
// rotated value rounded to bf16 goes back in place, the residual (rotated
// value minus that rounding), rounded to bf16, to `lo` at the same offset.
// Rows at or past S (zeros from TMA) keep their zeros, with a zero residual.
template <int ROWS, int NSUB>
__device__ __forceinline__ void rotate_tile(uint8_t* hi, uint8_t* lo, int p0, int S,
                                            const float* __restrict__ cos_t,
                                            const float* __restrict__ sin_t, int tid, int nt) {
  constexpr int H = NSUB * 32;  // table row length, W / 2
  constexpr int CHUNKS = ROWS * NSUB * 8;
  for (int ci = tid; ci < CHUNKS; ci += nt) {
    // Chunk ci sits at byte 16 ci: sub-tile ci / (8 ROWS), row, physical chunk.
    const int sub = ci / (ROWS * 8), r = ci % (ROWS * 8) / 8, pc = ci % 8;
    const int col0 = sub * 64 + (pc ^ (r & 7)) * 8;  // its first logical column
    const int pos = p0 + r;
    uint4* ph = reinterpret_cast<uint4*>(hi) + ci;
    uint4 vl = make_uint4(0u, 0u, 0u, 0u);
    if (pos < S) {
      uint4 vh = *ph;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&vh);
      __nv_bfloat162* l2 = reinterpret_cast<__nv_bfloat162*>(&vl);
      const float4 c4 = *reinterpret_cast<const float4*>(cos_t + (size_t)pos * H + col0 / 2);
      const float4 s4 = *reinterpret_cast<const float4*>(sin_t + (size_t)pos * H + col0 / 2);
      const float cs[4] = {c4.x, c4.y, c4.z, c4.w}, sn[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(h2[i]);
        const float ye = x.x * cs[i] - x.y * sn[i];
        const float yo = x.x * sn[i] + x.y * cs[i];
        const __nv_bfloat162 yh = __floats2bfloat162_rn(ye, yo);
        const float2 yf = __bfloat1622float2(yh);
        h2[i] = yh;
        l2[i] = __floats2bfloat162_rn(ye - yf.x, yo - yf.y);
      }
      *ph = vh;
    }
    reinterpret_cast<uint4*>(lo)[ci] = vl;
  }
}

// S (+)= A B^T for a 64-row A and a BK-key B, both K-major descriptors.
template <int BK>
__device__ __forceinline__ void mma_scores(float (&s)[BK / 2], uint64_t a, uint64_t b) {
  if constexpr (BK == 128) {
    wgmma_128_ss(s, a, b, 1);
  } else {
    wgmma_64_ss(s, a, b, 1);
  }
}

// K and V tile `tile` of head bh into stage st.
template <typename G>
__device__ __forceinline__ void load_kv(uint8_t* sm, uint64_t* bar, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int tile, int st, int bh) {
  mbar_expect_tx(bar, 2 * G::T_BYTES);
#pragma unroll
  for (int j = 0; j < G::NSUB; ++j) {
    tma_load_3d(sm + G::K_OFF + st * G::T_BYTES + j * G::BK * 128, tk, bar, 64 * j,
                tile * G::BK, bh);
    tma_load_3d(sm + G::V_OFF + st * G::T_BYTES + j * G::BK * 128, tv, bar, 64 * j,
                tile * G::BK, bh);
  }
}

template <int D, bool ROPE, bool CAUSAL>
__global__ void __launch_bounds__(Geo<D, ROPE>::NT, D == 64 ? 2 : 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int S, float scale) {
  using G = Geo<D, ROPE>;
  constexpr int BK = G::BK, BQ = G::BQ, NSUB = G::NSUB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + G::BAR_OFF);  // [0] Q, [1 + st] K/V
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  // Causal: the longest query tiles first, so the short ones fill the tail.
  const int q0 = (CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int n_tiles = ((CAUSAL ? min(q0 + BQ, S) : S) + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], G::Q_BYTES);
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
      tma_load_3d(sm + G::Q_OFF + j * BQ * 128, &tm_q, &bars[0], 64 * j, q0, bh);
    for (int st = 0; st < STAGES && st < n_tiles; ++st)
      load_kv<G>(sm, &bars[1 + st], &tm_k, &tm_v, st, st, bh);
  }

  const int row_a = q0 + wg * 64 + warp * 16 + lane / 4;  // this thread's rows: row_a, row_a + 8
  const int wg_first = q0 + wg * 64;
  const float sl2 = scale * LOG2E;
  float o[NSUB][32];
#pragma unroll
  for (int j = 0; j < NSUB; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  }
  float m0 = MASK, m1 = MASK, l0 = 0.f, l1 = 0.f;

  mbar_wait(&bars[0], 0);
  if constexpr (ROPE) {
    rotate_tile<BQ, NSUB>(sm + G::Q_OFF, sm + G::QLO_OFF, q0, S, cos_t, sin_t, tid, G::NT);
    fence_proxy_async();
    __syncthreads();
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    mbar_wait(&bars[1 + st], (j / STAGES) & 1);
    const int k0 = j * BK;
    uint8_t* kt = sm + G::K_OFF + st * G::T_BYTES;
    const uint8_t* vt = sm + G::V_OFF + st * G::T_BYTES;
    if constexpr (ROPE) {
      rotate_tile<BK, NSUB>(kt, sm + G::KLO_OFF, k0, S, cos_t, sin_t, tid, G::NT);
      fence_proxy_async();
      __syncthreads();
    }
    // Causal: a tile wholly above this warpgroup's rows adds nothing to them.
    if (!CAUSAL || k0 <= wg_first + 63) {
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int qoff = kk / 4 * BQ * 128 + wg * 64 * 128;
        const int koff = kk / 4 * BK * 128;
        const int step = kk % 4 * 2;  // 32 bytes along the swizzled row
        const uint64_t dq = desc_sw128(sm + G::Q_OFF + qoff) + step;
        const uint64_t dk = desc_sw128(kt + koff) + step;
        mma_scores<BK>(s, dq, dk);
        if constexpr (ROPE) {
          mma_scores<BK>(s, dq, desc_sw128(sm + G::KLO_OFF + koff) + step);
          mma_scores<BK>(s, desc_sw128(sm + G::QLO_OFF + qoff) + step, dk);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // Online softmax on the fragments: s[4 n + e] is row row_a + 8 (e / 2),
      // key k0 + 8 n + 2 (lane % 4) + e % 2.
      const bool edge = k0 + BK > S || (CAUSAL && k0 + BK - 1 > wg_first);
      float mx0 = MASK, mx1 = MASK;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = s[i] * sl2;
        if (edge) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          const int row = row_a + 8 * ((i / 2) & 1);
          if (key >= S || (CAUSAL && key > row)) x = MASK;
        }
        s[i] = x;
        if ((i / 2) & 1) {
          mx1 = fmaxf(mx1, x);
        } else {
          mx0 = fmaxf(mx0, x);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = fast_exp2(m0 - mn0), a1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if ((i / 2) & 1) {
          s[i] = fast_exp2(s[i] - mn1);
          rs1 += s[i];
        } else {
          s[i] = fast_exp2(s[i] - mn0);
          rs0 += s[i];
        }
      }
      l0 = l0 * a0 + rs0;  // per-thread partial sums: the quad is summed at the end
      l1 = l1 * a1 + rs1;
#pragma unroll
      for (int jj = 0; jj < NSUB; ++jj) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[jj][i] *= ((i / 2) & 1) ? a1 : a0;
      }
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < NSUB; ++jj)
          wgmma_64_rs_mn(o[jj], pa[kk], desc_sw128(vt + jj * BK * 128 + kk * 16 * 128));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int jj = 0; jj < NSUB; ++jj) fence_regs(o[jj]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
    }
    __syncthreads();  // every warpgroup is done with this stage
    if (tid == 0 && j + STAGES < n_tiles) load_kv<G>(sm, &bars[1 + st], &tm_k, &tm_v, j + STAGES,
                                                     st, bh);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const size_t base = (size_t)bh * S;
#pragma unroll
  for (int jj = 0; jj < NSUB; ++jj) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = jj * 64 + 8 * n + 2 * (lane % 4);
      if (row_a < S)
        *reinterpret_cast<__nv_bfloat162*>(out + (base + row_a) * D + col) =
            __floats2bfloat162_rn(o[jj][4 * n] * i0, o[jj][4 * n + 1] * i0);
      if (row_a + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(out + (base + row_a + 8) * D + col) =
            __floats2bfloat162_rn(o[jj][4 * n + 2] * i1, o[jj][4 * n + 3] * i1);
    }
  }
  if (lse != nullptr && lane % 4 == 0) {
    if (row_a < S) lse[base + row_a] = (m0 + log2f(l0)) * LN2;
    if (row_a + 8 < S) lse[base + row_a + 8] = (m1 + log2f(l1)) * LN2;
  }
}

template <int D, bool ROPE, bool CAUSAL>
cudaError_t launch_kernel(const void* q, const void* k, const void* v, const float* cs,
                          const float* sn, void* out, float* lse, int BH, int S, float scale,
                          cudaStream_t stream) {
  using G = Geo<D, ROPE>;
  CUtensorMap tq, tk, tv;
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)BH};
  const uint32_t box_q[2] = {64, G::BQ}, box_kv[2] = {64, G::BK};
  if (!encode_bf16(&tq, q, 3, dims, box_q) || !encode_bf16(&tk, k, 3, dims, box_kv) ||
      !encode_bf16(&tv, v, 3, dims, box_kv))
    return cudaErrorInvalidValue;
  static int ready = -1;
  const cudaError_t err = allow_smem(flash_fwd_tc_kernel<D, ROPE, CAUSAL>, G::BYTES, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + G::BQ - 1) / G::BQ, BH);
  flash_fwd_tc_kernel<D, ROPE, CAUSAL><<<grid, G::NT, G::BYTES, stream>>>(
      tq, tk, tv, cs, sn, (__nv_bfloat16*)out, lse, S, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const float* cs,
                     const float* sn, void* out, float* lse, int BH, int S, float scale,
                     bool causal, cudaStream_t stream) {
  if (cs != nullptr) return launch_kernel<D, true, true>(q, k, v, cs, sn, out, lse, BH, S, scale,
                                                         stream);
  if (causal) return launch_kernel<D, false, true>(q, k, v, cs, sn, out, lse, BH, S, scale,
                                                   stream);
  return launch_kernel<D, false, false>(q, k, v, cs, sn, out, lse, BH, S, scale, stream);
}

}  // namespace tc

cudaError_t launch_f32(int D, const void* q, const void* k, const void* v, const float* cs,
                       const float* sn, void* out, float* lse, int BH, int S, int W, float scale,
                       bool causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch_cores<float, 16>(q, k, v, cs, sn, out, lse, BH, S, W, scale, causal, s);
    case 32: return launch_cores<float, 32>(q, k, v, cs, sn, out, lse, BH, S, W, scale, causal, s);
    case 64: return launch_cores<float, 64>(q, k, v, cs, sn, out, lse, BH, S, W, scale, causal, s);
    case 128:
      return launch_cores<float, 128>(q, k, v, cs, sn, out, lse, BH, S, W, scale, causal, s);
    case 256:
      return launch_cores<float, 256>(q, k, v, cs, sn, out, lse, BH, S, W, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/out (BH, S, W), contiguous and 16-byte aligned, W the padded width of
// the true head dim d_true <= W (columns past d_true are zero): float32 at W
// in {16, 32, 64, 128, 256} or any multiple of 256; bf16 at W in {64, 128,
// 256} (tensor cores) or any multiple of 256 above (CUDA cores).  causal: 1
// for the causal mask, 0 for none.  cos/sin: NULL, or float32 (S, W/2) tables
// for RoPE in the kernel (both or neither; causal only).  lse: NULL, or
// float32 (BH, S) for the row logsumexp.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      const void* cos, const void* sin, void* out, void* lse,
                                      int BH, int S, int W, int d_true, int causal,
                                      void* stream) {
  if (BH <= 0 || S <= 0 || BH > 65535 || d_true <= 0 || d_true > W || (W > 256 && W % 256))
    return (int)cudaErrorInvalidValue;
  if ((cos == nullptr) != (sin == nullptr) || (cos != nullptr && !causal))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float *cs = (const float*)cos, *sn = (const float*)sin;
  float* l = (float*)lse;
  const bool c = causal != 0;
  const float scale = 1.0f / sqrtf((float)d_true);
  const int D = W > 256 ? 256 : W;  // register width of the CUDA-core kernel
  if (dtype == F32) return (int)launch_f32(D, q, k, v, cs, sn, out, l, BH, S, W, scale, c, s);
  if (dtype != BF16) return (int)cudaErrorInvalidValue;
  switch (W) {
    case 64: return (int)tc::launch_d<64>(q, k, v, cs, sn, out, l, BH, S, scale, c, s);
    case 128: return (int)tc::launch_d<128>(q, k, v, cs, sn, out, l, BH, S, scale, c, s);
    case 256: return (int)tc::launch_d<256>(q, k, v, cs, sn, out, l, BH, S, scale, c, s);
    default:
      if (W < 256) return (int)cudaErrorInvalidValue;
      return (int)launch_cores<__nv_bfloat16, 256>(q, k, v, cs, sn, out, l, BH, S, W, scale, c,
                                                   s);
  }
}
