// Decode-step (single-query) attention read through a block table from the
// paged KV pool.
//
// Replaces: bpe_transformer_tpu/kernels/pallas/decode_attention.py
//   paged_decode_attention (line 284; kernel _paged_decode_kernel at 222,
//   pallas_call at 414).
// Computes: out[s, h] = softmax(q[s, h] . k[s, kv, 0..pos[s]] / sqrt(d)) v[...]
//   with kv = h / (H / KV), where key j of slot s is row j % bs of pool block
//   tables[s][j / bs]:
//   q (S, H, d), k/v pool (NB, KV, bs, d), tables (S, nbs) int32, pos (S,)
//   int32 -> out (S, H, d) in q's type.  The pool holds q's type, or int8
//   with one float32 scale per (block, kv head) in k_scale / v_scale
//   (NB, KV), applied in registers.  Any head dim d and any group H / KV,
//   with the geometry of decode_attention.cu (padded widths W, register
//   widths D = min(W, 256) with W / D output-column chunks on gridDim.y,
//   head chunks G, rows of d elements read in place, and the common case's
//   own copy of the score and value passes without column tests).
//
// Bound on the H100: bytes.  Each live key row (keys 0..pos of the slot) is
// read once, with its block's two scales for an int8 pool, and used for
// 4 * G * d flops: far below the ~295 flops per byte where the card turns
// compute-bound.  The floor is the live K/V bytes over 3.35 TB/s.
//
// Design: the dense kernel (decode_attention.cu) with the block table in the
// addressing.  One block per (slot, kv head) reads that head's live rows
// once for the G query heads of its group; WARPS warps stride 32-key tiles
// with private online-softmax states and merge once through shared memory.
// The block first copies the live part of its slot's table row (entries
// 0..pos / bs) into shared memory; no entry past pos / bs is read, since
// those may be the trash block 0 or stale.  In the score pass each lane owns
// one key: it looks up that key's block, forms the row's offset
// ((block * KV + kv) * bs + j % bs) * d, and reads the row with 16-byte
// loads; a 32-key tile may span several pool blocks when bs < 32, which is
// why the lookup is per key and not per tile.  The value pass shuffles each
// row's offset and weight from the lane that owns the key, so lanes then
// read consecutive columns of one row (coalesced).  For an int8 pool the K
// scale multiplies the key's dot product and the V scale its softmax weight
// (dequantization is linear, so this equals attending over k * scale and
// v * scale); the denominator sums the unscaled weights.  Accumulation is
// float32 for every type.  The kernel is templated on q's type and, apart
// from it, on the pool's storage type (q's type or int8).

#include <type_traits>

#include "common.cuh"

using namespace port;

namespace {

constexpr int WARPS = 4;

template <typename TQ, typename TKV, int D, int G>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ pos, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, TQ* __restrict__ out, int H, int KV,
                    int bs, int nbs, int dt, int W, int group, int n_chunks, float scale) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  constexpr int DL = D < 32 ? D : 32;  // lanes across one row in the value pass
  constexpr int KPL = 32 / DL;         // rows side by side in the value pass
  constexpr int DPL = D / DL;          // columns per lane in the value pass
  constexpr int E = Vec16<TKV>::N;     // elements per 16-byte load

  extern __shared__ __align__(16) float dyn_sh[];
  float* q_sh = dyn_sh;                                     // [G][W]: query heads, scaled
  int* tab_sh = reinterpret_cast<int*>(dyn_sh + G * W);     // the slot's live table entries
  __shared__ float m_sh[WARPS][G];
  __shared__ float l_sh[WARPS][G];
  __shared__ float acc_sh[WARPS][G][D];

  const int s = blockIdx.x / (KV * n_chunks);
  const int kvh = blockIdx.x / n_chunks % KV;
  const int head0 = kvh * group + blockIdx.x % n_chunks * G;  // first query head
  const int ng = min(G, kvh * group + group - head0);           // live heads of the chunk
  const int z0 = blockIdx.y * D;  // first output column of this block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_keys = min(pos[s], nbs * bs - 1) + 1;
  const int n_blocks = (n_keys + bs - 1) / bs;

  for (int i = threadIdx.x; i < n_blocks; i += blockDim.x) tab_sh[i] = tables[(size_t)s * nbs + i];
  const TQ* qb = q + ((size_t)s * H + head0) * dt;
  for (int i = threadIdx.x; i < G * W; i += blockDim.x) {
    const int g = i / W, c = i % W;
    q_sh[i] = (g < ng && c < dt) ? to_f(qb[(size_t)g * dt + c]) * scale : 0.f;
  }
  __syncthreads();

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = MASK;
    l[g] = 0.f;
#pragma unroll
    for (int r = 0; r < DPL; ++r) acc[g][r] = 0.f;
  }
  const int col0 = lane % DL;
  const int sub = lane / DL;
  // The common case: the head dim is its register width, one column chunk.
  const bool whole = dt == D && W == D;

  for (int t0 = warp * 32; t0 < n_keys; t0 += WARPS * 32) {
    const int key = t0 + lane;
    const bool live = key < n_keys;
    long long row = 0;  // element offset of this lane's key row in the pool
    float vs = 0.f;     // weight factor of the row in the value pass
    float s_[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s_[g] = 0.f;
    if (live) {
      const int blk = tab_sh[key / bs];
      const size_t bh = (size_t)blk * KV + kvh;
      row = (long long)((bh * bs + key % bs) * dt);
      const TKV* kr = kp + row;
      if (whole) {  // one chunk: q at compile-time offsets, held in registers
        const float (*qs)[D] = reinterpret_cast<const float (*)[D]>(q_sh);
#pragma unroll
        for (int c0 = 0; c0 < D; c0 += E) {
          float kv[E];
          load16(kr + c0, kv);
#pragma unroll
          for (int e = 0; e < E; ++e) {
#pragma unroll
            for (int g = 0; g < G; ++g) s_[g] += qs[g][c0 + e] * kv[e];
          }
        }
      } else if (dt == W) {
        for (int cb = 0; cb < W; cb += D) {
#pragma unroll
          for (int c1 = 0; c1 < D; c1 += E) {
            const int c0 = cb + c1;
            float kv[E];
            load16(kr + c0, kv);
            // q as 16-byte broadcast reads (rows of W floats, W a multiple of 4).
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float4* qv = reinterpret_cast<const float4*>(q_sh + g * W + c0);
#pragma unroll
              for (int e4 = 0; e4 < E / 4; ++e4) {
                const float4 t = qv[e4];
                s_[g] += t.x * kv[4 * e4];
                s_[g] += t.y * kv[4 * e4 + 1];
                s_[g] += t.z * kv[4 * e4 + 2];
                s_[g] += t.w * kv[4 * e4 + 3];
              }
            }
          }
        }
      } else {  // a padded head dim: rows of dt elements, scalar loads
        for (int c = 0; c < dt; ++c) {
          const float kv = to_f(kr[c]);
#pragma unroll
          for (int g = 0; g < G; ++g) s_[g] += q_sh[g * W + c] * kv;
        }
      }
      if constexpr (QUANT) {
        const float ks = k_scale[bh];
#pragma unroll
        for (int g = 0; g < G; ++g) s_[g] *= ks;
        vs = v_scale[bh];
      } else {
        vs = 1.f;
      }
    }
    float pv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sg = live ? s_[g] : MASK;
      const float m_new = fmaxf(m[g], warp_max(sg));
      const float alpha = expf(m[g] - m_new);
      const float p = live ? expf(sg - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p);
      m[g] = m_new;
      pv[g] = p * vs;
#pragma unroll
      for (int r = 0; r < DPL; ++r) acc[g][r] *= alpha;
    }
    // Value pass: KPL rows at a time, DPL columns per lane; each row's
    // offset and weights come from the lane that owns its key.  Unrolled,
    // with each row's load predicated on the row being live.
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += KPL) {
      const int j = j0 + sub;
      float pj[G];
#pragma unroll
      for (int g = 0; g < G; ++g) pj[g] = __shfl_sync(0xffffffffu, pv[g], j);
      const long long rj = __shfl_sync(0xffffffffu, row, j);
      if (t0 + j < n_keys) {
        const TKV* vr = vp + rj;
        if (whole) {  // no column to mask: plain loads, all in flight together
#pragma unroll
          for (int r = 0; r < DPL; ++r) {
            const float vv = to_f(vr[col0 + r * DL]);
#pragma unroll
            for (int g = 0; g < G; ++g) acc[g][r] += pj[g] * vv;
          }
        } else {
#pragma unroll
          for (int r = 0; r < DPL; ++r) {
            const int col = z0 + col0 + r * DL;
            const float vv = col < dt ? to_f(vr[col]) : 0.f;
#pragma unroll
            for (int g = 0; g < G; ++g) acc[g][r] += pj[g] * vv;
          }
        }
      }
    }
  }
  // Rows handled side by side (D < 32) hold partial sums of the same columns.
#pragma unroll
  for (int off = DL; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int r = 0; r < DPL; ++r) acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], off);
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int r = 0; r < DPL; ++r) acc_sh[warp][g][col0 + r * DL] = acc[g][r];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_sh[warp][g] = m[g];
      l_sh[warp][g] = l[g];
    }
  }
  __syncthreads();
  // Merge the warps' partial softmax states (a warp that saw no key holds
  // m = MASK, l = 0 and contributes exp(MASK - M) = 0).
  TQ* ob = out + ((size_t)s * H + head0) * dt;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, c = i % D;
    if (g >= ng || z0 + c >= dt) continue;
    float mx = MASK;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_sh[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(m_sh[w][g] - mx);
      den += l_sh[w][g] * f;
      num += acc_sh[w][g][c] * f;
    }
    ob[(size_t)g * dt + z0 + c] = from_f<TQ>(num / fmaxf(den, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v;
  const int *tables, *pos;
  const float *k_scale, *v_scale;
  void* out;
  int S, H, KV, bs, nbs, dt, W, G, n_chunks;
};

template <typename TQ, typename TKV, int D, int G>
cudaError_t launch_g(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.S * a.KV * a.n_chunks, a.W / D), block(WARPS * 32);
  const size_t smem = (size_t)G * a.W * sizeof(float) + (size_t)a.nbs * sizeof(int);
  if (smem > 32 * 1024) {  // with the static buffers, past the 48 KB default
    const cudaError_t err =
        cudaFuncSetAttribute(paged_decode_kernel<TQ, TKV, D, G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_decode_kernel<TQ, TKV, D, G><<<grid, block, smem, stream>>>(
      (const TQ*)a.q, (const TKV*)a.k, (const TKV*)a.v, a.tables, a.pos, a.k_scale, a.v_scale,
      (TQ*)a.out, a.H, a.KV, a.bs, a.nbs, a.dt, a.W, a.H / a.KV, a.n_chunks,
      1.0f / sqrtf((float)a.dt));
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  switch (a.G) {
    case 1: return launch_g<TQ, TKV, D, 1>(a, stream);
    case 2: return launch_g<TQ, TKV, D, 2>(a, stream);
    case 4: return launch_g<TQ, TKV, D, 4>(a, stream);
    case 8:
      if constexpr (D <= 128) return launch_g<TQ, TKV, D, 8>(a, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
cudaError_t launch_t(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<TQ, TKV, 16>(a, stream);
    case 32: return launch_d<TQ, TKV, 32>(a, stream);
    case 64: return launch_d<TQ, TKV, 64>(a, stream);
    case 128: return launch_d<TQ, TKV, 128>(a, stream);
    case 256: return launch_d<TQ, TKV, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (S, H, d) and out in q's type (dtype code), k/v pools (NB, KV, bs, d) in
// q's type or int8 (kv_dtype code), tables (S, nbs) int32, pos (S,) int32,
// k_scale / v_scale (NB, KV) float32 for int8 pools (else NULL); all
// contiguous.  W in {16, 32, 64, 128, 256} or a multiple of 256 is the padded
// width of the true head dim d <= W (the register width is min(W, 256)); the
// group H / KV runs in n_chunks chunks of G in {1, 2, 4, 8} heads (G <= 4
// from W = 256), G * n_chunks >= H / KV; G * W * 4 + nbs * 4 bytes of dynamic
// shared memory (nbs <= 4096).
extern "C" int paged_decode_attention_launch(int dtype, const void* q, const void* k,
                                             const void* v, const void* tables, const void* pos,
                                             const void* k_scale, const void* v_scale, void* out,
                                             int kv_dtype, int S, int H, int KV, int bs, int nbs,
                                             int W, int d, int G, int n_chunks, void* stream) {
  if (S <= 0 || KV <= 0 || H % KV || bs <= 0 || nbs <= 0 || nbs > 4096 || d <= 0 || d > W ||
      n_chunks <= 0 || G * n_chunks < H / KV || (W > 256 && W % 256) || W / 256 > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, (const int*)tables, (const int*)pos, (const float*)k_scale,
               (const float*)v_scale, out, S, H, KV, bs, nbs, d, W, G, n_chunks};
  const int D = W > 256 ? 256 : W;
  const cudaStream_t s = (cudaStream_t)stream;
  if (kv_dtype == I8 && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == F32 && kv_dtype == F32) return (int)launch_t<float, float>(D, a, s);
  if (dtype == F32 && kv_dtype == I8) return (int)launch_t<float, int8_t>(D, a, s);
  if (dtype == BF16 && kv_dtype == BF16)
    return (int)launch_t<__nv_bfloat16, __nv_bfloat16>(D, a, s);
  if (dtype == BF16 && kv_dtype == I8) return (int)launch_t<__nv_bfloat16, int8_t>(D, a, s);
  return (int)cudaErrorInvalidValue;
}
