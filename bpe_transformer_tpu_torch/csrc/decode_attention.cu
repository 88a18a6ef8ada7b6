// Decode-step (single-query) attention against a dense KV cache.
//
// Replaces: bpe_transformer_tpu/kernels/pallas/decode_attention.py
//   decode_attention (line 107; kernel _decode_kernel, pallas_call at 213).
// Computes: out[b, h] = softmax(q[b, h] . k[b, kv, 0..pos[b]] / sqrt(d)) v[...]
//   with kv = h / (H / KV): GQA groups are consecutive query heads.
//   q (B, H, d), k/v cache (B, KV, ctx, d), pos (B,) int32 -> out (B, H, d).
//
// Bound on the H100: bytes.  Each live cache row (keys 0..pos) is read once
// and used for 4 * G * d flops, far below the ~295 flops per byte where the
// card turns compute-bound; the kernel's floor is the live K/V bytes over
// 3.35 TB/s.
//
// Design against that bound: one block per (batch, kv head) reads that head's
// live rows exactly once for all G query heads of its group, and never touches
// a row past pos (the TPU kernel's clamped index map; here the loop simply ends
// at pos, so a ragged ctx needs no padding).  The TPU's sequential key grid
// becomes a loop inside the block, split over WARPS warps that each keep their
// own online-softmax state (max, denominator, accumulator) in registers, so
// that WARPS independent streams of loads are in flight; the warps merge once
// through shared memory at the end.  Within a warp, the score pass gives each
// lane one key (16-byte vector loads along its row), and the value pass gives
// each lane D/32 columns of consecutive rows, so value loads are coalesced;
// that pass is unrolled over the 32 rows so their loads overlap (rolled, the
// warp waited one load latency per row).
// Scores and probabilities never leave registers.  Accumulation is float32
// for both input types.

#include "common.cuh"

using namespace port;

namespace {

constexpr int WARPS = 4;

template <typename T, int D, int G>
__global__ void __launch_bounds__(WARPS * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, int H, int KV, int ctx, float scale) {
  constexpr int DL = D < 32 ? D : 32;   // lanes across one row in the value pass
  constexpr int KPL = 32 / DL;          // rows side by side in the value pass
  constexpr int DPL = D / DL;           // columns per lane in the value pass
  constexpr int E = Vec16<T>::N;        // elements per 16-byte load

  __shared__ float q_sh[G][D];
  __shared__ float m_sh[WARPS][G];
  __shared__ float l_sh[WARPS][G];
  __shared__ float acc_sh[WARPS][G][D];

  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_keys = min(pos[b], ctx - 1) + 1;

  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) q_sh[i / D][i % D] = to_f(qb[i]) * scale;
  __syncthreads();

  const size_t head_off = ((size_t)b * KV + kvh) * (size_t)ctx * D;
  const T* kb = k + head_off;
  const T* vb = v + head_off;

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

  for (int t0 = warp * 32; t0 < n_keys; t0 += WARPS * 32) {
    const int key = t0 + lane;
    const bool live = key < n_keys;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (live) {
      const T* kr = kb + (size_t)key * D;
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += E) {
        float kv[E];
        load16(kr + c0, kv);
#pragma unroll
        for (int e = 0; e < E; ++e) {
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] += q_sh[g][c0 + e] * kv[e];
        }
      }
    }
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sg = live ? s[g] : MASK;
      const float m_new = fmaxf(m[g], warp_max(sg));
      const float alpha = expf(m[g] - m_new);
      p[g] = live ? expf(sg - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int r = 0; r < DPL; ++r) acc[g][r] *= alpha;
    }
    // Value pass: KPL rows at a time, DPL columns per lane.  Unrolled, with
    // each row's load predicated on the row being live, so the warp has all
    // of its row loads in flight at once instead of one load latency per row.
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += KPL) {
      const int j = j0 + sub;
      float pj[G];
#pragma unroll
      for (int g = 0; g < G; ++g) pj[g] = __shfl_sync(0xffffffffu, p[g], j);
      if (t0 + j < n_keys) {
        const T* vr = vb + (size_t)(t0 + j) * D;
#pragma unroll
        for (int r = 0; r < DPL; ++r) {
          const float vv = to_f(vr[col0 + r * DL]);
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g][r] += pj[g] * vv;
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
  T* ob = out + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, c = i % D;
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
    ob[i] = from_f<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch_d(int G, const void* q, const void* k, const void* v, const int* pos,
                     void* out, int B, int H, int KV, int ctx, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid(B * KV), block(WARPS * 32);
#define PORT_DECODE_CASE(GG)                                                          \
  case GG:                                                                            \
    decode_attention_kernel<T, D, GG><<<grid, block, 0, stream>>>(                   \
        (const T*)q, (const T*)k, (const T*)v, pos, (T*)out, H, KV, ctx, scale);     \
    break;
  switch (G) {
    PORT_DECODE_CASE(1)
    PORT_DECODE_CASE(2)
    PORT_DECODE_CASE(4)
    PORT_DECODE_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PORT_DECODE_CASE
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int G, int d, const void* q, const void* k, const void* v, const int* pos,
                     void* out, int B, int H, int KV, int ctx, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_d<T, 16>(G, q, k, v, pos, out, B, H, KV, ctx, stream);
    case 32: return launch_d<T, 32>(G, q, k, v, pos, out, B, H, KV, ctx, stream);
    case 64: return launch_d<T, 64>(G, q, k, v, pos, out, B, H, KV, ctx, stream);
    case 128: return launch_d<T, 128>(G, q, k, v, pos, out, B, H, KV, ctx, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, d), k/v (B, KV, ctx, d), pos (B,) int32, out (B, H, d); all
// contiguous.  d in {16, 32, 64, 128}; H / KV in {1, 2, 4, 8}.
extern "C" int decode_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                       const void* pos, void* out, int B, int H, int KV,
                                       int ctx, int d, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV || ctx <= 0) return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* p = (const int*)pos;
  if (dtype == F32) return (int)launch_t<float>(G, d, q, k, v, p, out, B, H, KV, ctx, s);
  if (dtype == BF16) return (int)launch_t<__nv_bfloat16>(G, d, q, k, v, p, out, B, H, KV, ctx, s);
  return (int)cudaErrorInvalidValue;
}
