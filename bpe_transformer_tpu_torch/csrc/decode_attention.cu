// Decode-step (single-query) attention against a dense KV cache.
//
// Replaces: bpe_transformer_tpu/kernels/pallas/decode_attention.py
//   decode_attention (line 107; kernel _decode_kernel, pallas_call at 213).
// Computes: out[b, h] = softmax(q[b, h] . k[b, kv, 0..pos[b]] / sqrt(d)) v[...]
//   with kv = h / (H / KV): GQA groups are consecutive query heads.
//   q (B, H, d), k/v cache (B, KV, ctx, d), pos (B,) int32 -> out (B, H, d),
//   for any head dim d and any group H / KV (the JAX kernel pads d to 128
//   lanes and the group to 8 sublanes).
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
//
// Geometry: the kernel is instantiated for register widths D in {16, 32, 64,
// 128, 256} and head chunks G in {1, 2, 4, 8} (at most 4 at D = 256, to keep
// the warps' merge buffer within static shared memory).  A head dim d below
// its padded width W is read in place (rows of d elements, scalar loads
// instead of 16-byte vectors; the columns past d are zero in registers and
// never stored), with the softmax scale of d.  Up to 256, W is the register
// width D; above it, W is d rounded up to a multiple of 256, D = 256, and
// the W / 256 output-column chunks run on gridDim.y so that registers do not
// grow with d: every chunk's block scores the full row (q of the whole width
// in dynamic shared memory) and accumulates only its own 256 columns of the
// value rows, re-reading the key rows once per chunk (off the main path: no
// preset has a head dim above 128).  Those two cases mask columns; the
// common one (d equal to its register width, one chunk) takes its own copy
// of the score and value passes without any column test, so q stays at
// compile-time offsets and the value pass's row loads are issued together
// (with a per-column test in that pass the kernel ran ~2.5x slower).  A group of g query heads is cut into
// ceil(g / G) chunks of G heads, one block each (the last one masks the heads
// past g); the wrapper picks the smallest G that holds the group, so a group
// of 3 runs one chunk of 4 and a group of 12 two chunks of 8, and every
// chunk reads its kv head's rows.

#include "common.cuh"

using namespace port;

namespace {

constexpr int WARPS = 4;

template <typename T, int D, int G>
__global__ void __launch_bounds__(WARPS * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, int H, int KV, int ctx, int dt, int W, int group,
                        int n_chunks, float scale) {
  constexpr int DL = D < 32 ? D : 32;   // lanes across one row in the value pass
  constexpr int KPL = 32 / DL;          // rows side by side in the value pass
  constexpr int DPL = D / DL;           // columns per lane in the value pass
  constexpr int E = Vec16<T>::N;        // elements per 16-byte load

  extern __shared__ __align__(16) float q_sh[];  // [G][W]: the chunk's query heads, scaled
  __shared__ float m_sh[WARPS][G];
  __shared__ float l_sh[WARPS][G];
  __shared__ float acc_sh[WARPS][G][D];

  const int b = blockIdx.x / (KV * n_chunks);
  const int kvh = blockIdx.x / n_chunks % KV;
  const int head0 = kvh * group + blockIdx.x % n_chunks * G;  // first query head
  const int ng = min(G, kvh * group + group - head0);           // live heads of the chunk
  const int z0 = blockIdx.y * D;  // first output column of this block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_keys = min(pos[b], ctx - 1) + 1;

  const T* qb = q + ((size_t)b * H + head0) * dt;
  for (int i = threadIdx.x; i < G * W; i += blockDim.x) {
    const int g = i / W, c = i % W;
    q_sh[i] = (g < ng && c < dt) ? to_f(qb[(size_t)g * dt + c]) * scale : 0.f;
  }
  __syncthreads();

  const size_t head_off = ((size_t)b * KV + kvh) * (size_t)ctx * dt;
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
  // The common case: the head dim is its register width, one column chunk.
  const bool whole = dt == D && W == D;

  for (int t0 = warp * 32; t0 < n_keys; t0 += WARPS * 32) {
    const int key = t0 + lane;
    const bool live = key < n_keys;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (live) {
      const T* kr = kb + (size_t)key * dt;
      if (whole) {  // one chunk: q at compile-time offsets, held in registers
        const float (*qs)[D] = reinterpret_cast<const float (*)[D]>(q_sh);
#pragma unroll
        for (int c0 = 0; c0 < D; c0 += E) {
          float kv[E];
          load16(kr + c0, kv);
#pragma unroll
          for (int e = 0; e < E; ++e) {
#pragma unroll
            for (int g = 0; g < G; ++g) s[g] += qs[g][c0 + e] * kv[e];
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
                s[g] += t.x * kv[4 * e4];
                s[g] += t.y * kv[4 * e4 + 1];
                s[g] += t.z * kv[4 * e4 + 2];
                s[g] += t.w * kv[4 * e4 + 3];
              }
            }
          }
        }
      } else {  // a padded head dim: rows of dt elements, scalar loads
        for (int c = 0; c < dt; ++c) {
          const float kv = to_f(kr[c]);
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] += q_sh[g * W + c] * kv;
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
        const T* vr = vb + (size_t)(t0 + j) * dt;
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
  T* ob = out + ((size_t)b * H + head0) * dt;
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
    ob[(size_t)g * dt + z0 + c] = from_f<T>(num / fmaxf(den, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v;
  const int* pos;
  void* out;
  int B, H, KV, ctx, dt, W, G, n_chunks;
};

template <typename T, int D, int G>
cudaError_t launch_g(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.KV * a.n_chunks, a.W / D), block(WARPS * 32);
  const size_t smem = (size_t)G * a.W * sizeof(float);
  if (smem > 32 * 1024) {  // with the static buffers, past the 48 KB default
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_attention_kernel<T, D, G><<<grid, block, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.pos, (T*)a.out, a.H, a.KV, a.ctx, a.dt, a.W,
      a.H / a.KV, a.n_chunks, 1.0f / sqrtf((float)a.dt));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  switch (a.G) {
    case 1: return launch_g<T, D, 1>(a, stream);
    case 2: return launch_g<T, D, 2>(a, stream);
    case 4: return launch_g<T, D, 4>(a, stream);
    case 8:
      if constexpr (D <= 128) return launch_g<T, D, 8>(a, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(a, stream);
    case 32: return launch_d<T, 32>(a, stream);
    case 64: return launch_d<T, 64>(a, stream);
    case 128: return launch_d<T, 128>(a, stream);
    case 256: return launch_d<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, d), k/v (B, KV, ctx, d), pos (B,) int32, out (B, H, d); all
// contiguous.  W in {16, 32, 64, 128, 256} or a multiple of 256 is the padded
// width of the true head dim d <= W (the register width is min(W, 256)); the
// group H / KV runs in n_chunks chunks of G in {1, 2, 4, 8} heads (G <= 4
// from W = 256), G * n_chunks >= H / KV.
extern "C" int decode_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                       const void* pos, void* out, int B, int H, int KV,
                                       int ctx, int W, int d, int G, int n_chunks,
                                       void* stream) {
  if (B <= 0 || KV <= 0 || H % KV || ctx <= 0 || d <= 0 || d > W || n_chunks <= 0 ||
      G * n_chunks < H / KV || (size_t)B * KV * n_chunks > 0x7fffffff ||
      (W > 256 && W % 256) || W / 256 > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, (const int*)pos, out, B, H, KV, ctx, d, W, G, n_chunks};
  const int D = W > 256 ? 256 : W;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32) return (int)launch_t<float>(D, a, s);
  if (dtype == BF16) return (int)launch_t<__nv_bfloat16>(D, a, s);
  return (int)cudaErrorInvalidValue;
}
