// The decode tick's tail (head projection, top-k/top-p filter, gumbel sample)
// and the speculative verify tail, each as a head-projection kernel followed
// by a finalize kernel of one block per row.
//
// Replaces: bpe_transformer_tpu/kernels/pallas/sample.py
//   fused_head_sample (line 335; kernel _sample_kernel at 180) and
//   fused_verify_head (line 373; kernel _verify_kernel at 205), which share
//   one pallas_call assembly (_run at 274, pallas_call at 321).
// Computes, for R rows of hidden x (R, d) f32 or bf16 against the head
//   h (V, d) f32, bf16, or int8 with a float32 scale (V,) per row:
//   logits[r, v] = scale[v] * sum_c x[r, c] h[v, c] (float32, into a (R, V)
//   workspace the caller owns; a head of another float type than x is
//   rounded to x's type first, as ops/core.py head_logits does), then per row
//   with runtime knobs temp (R,) f32, top_k (R,) int32, top_p (R,) f32:
//   * sample: token = argmax(logits) for temp 0, else
//     argmax(masked + gumbel) where masked keeps the filter_logits keep set
//     of logits / max(temp, 1e-6) and is MASK elsewhere;
//   * verify: greedy = argmax(logits); p = softmax over the keep set (the
//     one-hot of greedy for temp 0); p_d = p[judge]; bonus = the
//     gumbel-argmax sample of the residual max(p - q, 0) (p when it has no
//     mass), the plain argmax of it for temp 0.
//   Tokens are int64, first index on ties.
//
// Bound on the H100: bytes.  The head (49.2 MB in bf16 at GPT2_SMALL_32K) is
// read once for all rows, 2 R flops a head element; the gumbel (and q for
// verify) rows are read once.
//
// Design.  (a) head_logits_kernel: a block holds 8 hidden rows in shared
// memory as float32 and computes their logits against 64 head rows; each
// warp takes 4 head rows at a time, its lanes stride the reduction axis with
// 16-byte loads of the 4 rows, and the 32 partial sums (4 head rows x 8
// hidden rows) are reduced across the warp, after which lane l writes sum l.
// blockIdx.x walks the row tiles, so blocks that read the same head tile run
// side by side and the tiles after the first come from L2.  Products run on
// the CUDA cores in float32.
// (b) finalize_kernel: one block of 1024 threads per row.  The row is scaled
// (a true division, as the plain version divides) into shared memory, 128 KB
// at V 32000 (dynamic shared memory past 48 KB is opted into); a vocabulary
// too large for it reads the logits again from the workspace (L2) instead.
// The filter is the TPU kernel's sort-free radix descent over
// order-preserving uint32 keys: the top-k threshold is the largest key t with
// count(keys >= t) >= k, found bit by bit from the MSB with one block-wide
// count per bit; the nucleus threshold the smallest t whose kept mass
// strictly above t is below top_p times the kept mass, one block-wide sum
// per bit.  Both are exact key values, so the keep set is filter_logits'
// (only the nucleus mass sums in another order than the sorted cumsum: a
// logit within an ulp of the nucleus edge may flip).  A disabled top-k skips
// its descent, as does a nucleus that keeps everything (the descent's own
// predicate at t = 0, computed by the same sum); temp 0 rows take the raw
// argmax and skip the filter (for verify their p is the exact one-hot, so
// p_d is the argmax agreement and the bonus the argmax itself).  Sums and
// counts reduce in a fixed order (per thread, then a warp tree, then the 32
// warps), so results repeat bit for bit.  Faster forms (one fused launch,
// wgmma for the projection, 8-bit radix digits) are later work.
//
// Built without --use_fast_math: expf, logf and the division are IEEE.

#include <type_traits>

#include "common.cuh"

using namespace port;

namespace {

// ---------------------------------------------------------------- projection

constexpr int P_THREADS = 256;  // 8 warps
constexpr int RB = 8;           // hidden rows per block
constexpr int VW = 4;           // head rows per warp step (VW * RB = 32 sums)
constexpr int VPB = 64;         // head rows per block

// A head element as x's type would hold it (head_logits rounds the head to
// the hidden's dtype), widened to float32.  int8 values are exact.
template <typename TX, typename TH>
__device__ __forceinline__ float head_as_x(float h) {
  if (std::is_same<TX, __nv_bfloat16>::value && std::is_same<TH, float>::value)
    return __bfloat162float(__float2bfloat16(h));
  return h;
}

template <typename TX, typename TH, bool VEC>
__global__ void __launch_bounds__(P_THREADS)
head_logits_kernel(const TX* __restrict__ x, const TH* __restrict__ h,
                   const float* __restrict__ scale, float* __restrict__ logits, int R, int V,
                   int d) {
  extern __shared__ __align__(16) float xs[];  // [RB][d]
  const int r0 = blockIdx.x * RB;
  const int v0 = blockIdx.y * VPB;
  const int nr = min(RB, R - r0);
  for (int i = threadIdx.x; i < RB * d; i += P_THREADS) {
    const int r = i / d;
    xs[i] = r < nr ? to_f(x[(size_t)(r0 + r) * d + (i - r * d)]) : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int v_end = min(V, v0 + VPB);
  for (int vb = v0 + warp * VW; vb < v_end; vb += (P_THREADS / 32) * VW) {
    float acc[VW][RB];
#pragma unroll
    for (int v = 0; v < VW; ++v) {
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[v][r] = 0.f;
    }
    if (VEC) {
      constexpr int E = Vec16<TH>::N;
      for (int c0 = lane * E; c0 < d; c0 += 32 * E) {
        float w[VW][E];
#pragma unroll
        for (int v = 0; v < VW; ++v) {
          if (vb + v < V) {
            load16(h + (size_t)(vb + v) * d + c0, w[v]);
#pragma unroll
            for (int e = 0; e < E; ++e) w[v][e] = head_as_x<TX, TH>(w[v][e]);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) w[v][e] = 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float xv[E];
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 t = *reinterpret_cast<const float4*>(&xs[r * d + c0 + e]);
            xv[e] = t.x; xv[e + 1] = t.y; xv[e + 2] = t.z; xv[e + 3] = t.w;
          }
#pragma unroll
          for (int v = 0; v < VW; ++v) {
#pragma unroll
            for (int e = 0; e < E; ++e) acc[v][r] += xv[e] * w[v][e];
          }
        }
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        float w[VW];
#pragma unroll
        for (int v = 0; v < VW; ++v)
          w[v] = vb + v < V ? head_as_x<TX, TH>(to_f(h[(size_t)(vb + v) * d + c])) : 0.f;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float xv = xs[r * d + c];
#pragma unroll
          for (int v = 0; v < VW; ++v) acc[v][r] += xv * w[v];
        }
      }
    }
    // Every lane ends with all 32 sums; lane l writes sum (l / RB, l % RB).
    float mine = 0.f;
#pragma unroll
    for (int v = 0; v < VW; ++v) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float t = warp_sum(acc[v][r]);
        if (lane == v * RB + r) mine = t;
      }
    }
    const int v = vb + lane / RB, r = lane % RB;
    if (v < V && r < nr) {
      logits[(size_t)(r0 + r) * V + v] = scale != nullptr ? mine * scale[v] : mine;
    }
  }
}

// ------------------------------------------------------------------ finalize

constexpr int F_THREADS = 1024;
constexpr int F_WARPS = F_THREADS / 32;
constexpr int SAMPLE = 0;
constexpr int VERIFY = 1;

// f32 -> uint32 whose unsigned order is the float order (NaN-free inputs).
__device__ __forceinline__ unsigned okey(float x) {
  const unsigned b = __float_as_uint(x);
  return (b >> 31) ? ~b : (b | 0x80000000u);
}

// Block-wide reductions: every thread returns the same value, summed in a
// fixed order.  `red` holds F_WARPS entries; the leading barrier protects it
// from the previous reduction's readers.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(red[threadIdx.x & 31]);
}

__device__ int block_sum_int(int v, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[threadIdx.x & 31];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_max(red[threadIdx.x & 31]);
}

// (value, index) with the larger value, the smaller index on ties.
__device__ __forceinline__ void arg_merge(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ int block_argmax(float v, int i, float* redf, int* redi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    arg_merge(v, i, __shfl_xor_sync(0xffffffffu, v, off), __shfl_xor_sync(0xffffffffu, i, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    redf[threadIdx.x >> 5] = v;
    redi[threadIdx.x >> 5] = i;
  }
  __syncthreads();
  v = redf[threadIdx.x & 31];
  i = redi[threadIdx.x & 31];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    arg_merge(v, i, __shfl_xor_sync(0xffffffffu, v, off), __shfl_xor_sync(0xffffffffu, i, off));
  return i;
}

struct FinalizeArgs {
  const float* logits;  // (R, V) workspace
  const float* temps;
  const int* top_ks;
  const float* top_ps;
  const float* gumbel;  // (R, V)
  const int* judge;     // (R,) verify only
  const float* q;       // (R, V) verify only
  long long* tokens;    // sample: (R,) ; verify: greedy (R,)
  float* p_d;           // verify only
  long long* bonus;     // verify only
  int V;
};

template <int MODE, bool SMEM>
__global__ void __launch_bounds__(F_THREADS) finalize_kernel(FinalizeArgs a) {
  extern __shared__ __align__(16) float smem_row[];  // V scaled logits when SMEM
  __shared__ float smem_redf[F_WARPS];
  __shared__ int smem_redi[F_WARPS];
  // Plain pointers to the shared arrays, for the lambdas below.
  float* const srow = smem_row;
  float* const redf = smem_redf;
  int* const redi = smem_redi;
  const int V = a.V;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const float* lrow = a.logits + (size_t)r * V;
  const float temp = a.temps[r];
  const bool sampled = temp > 0.f;
  const float tdiv = fmaxf(temp, 1e-6f);

  // Pass 1: the raw argmax (first occurrence), and the scaled row.
  float best = 0.f, smax = -INFINITY;
  int bidx = V;
  for (int i = tid; i < V; i += F_THREADS) {
    const float l = lrow[i];
    if (bidx == V || l > best) {
      best = l;
      bidx = i;
    }
    if (sampled) {
      const float s = l / tdiv;
      smax = fmaxf(smax, s);
      if (SMEM) srow[i] = s;
    }
  }
  const int greedy = block_argmax(bidx == V ? -INFINITY : best, bidx, redf, redi);
  if (!sampled) {
    if (tid == 0) {
      a.tokens[r] = greedy;
      if (MODE == VERIFY) {
        a.p_d[r] = a.judge[r] == greedy ? 1.f : 0.f;
        a.bonus[r] = greedy;
      }
    }
    return;
  }
  auto scaled = [&](int i) -> float { return SMEM ? srow[i] : lrow[i] / tdiv; };
  const float m2 = block_max(smax, redf);  // the row max is always kept

  // Top-k: the largest key t with count(keys >= t) >= k.
  const int topk = a.top_ks[r];
  const int kk = topk > 0 ? min(topk, V) : V;
  unsigned tk = 0u;  // k == V keeps everything, as the least key would
  if (kk < V) {
    for (int bit = 31; bit >= 0; --bit) {
      const unsigned cand = tk | (1u << bit);
      int c = 0;
      for (int i = tid; i < V; i += F_THREADS) c += okey(scaled(i)) >= cand;
      if (block_sum_int(c, redi) >= kk) tk = cand;
    }
  }
  // The top-k kept mass strictly above key `trial` (weights exp(s - m2)).
  auto mass_above = [&](unsigned trial) -> float {
    float g = 0.f;
    for (int i = tid; i < V; i += F_THREADS) {
      const float s = scaled(i);
      const unsigned k = okey(s);
      if (k >= tk && k > trial) g += expf(s - m2);
    }
    return block_sum(g, redf);
  };
  // Nucleus: the smallest t whose kept mass strictly above it is below
  // top_p * z.  z is the same sum at t = 0: when even it is below, the
  // descent would end at 0 (every mass above a larger t is at most z).
  const float z = mass_above(0u);
  const float p_mass = a.top_ps[r] * z;
  unsigned tp = 0u;
  if (!(z < p_mass)) {
    for (int bit = 31; bit >= 0; --bit) {
      const unsigned trial = tp | ((1u << bit) - 1u);
      if (!(mass_above(trial) < p_mass)) tp |= 1u << bit;
    }
  }
  // The max and its value ties always survive.
  auto kept = [&](float s) -> bool {
    const unsigned k = okey(s);
    return k >= tk && (k >= tp || s == m2);
  };
  const float* grow = a.gumbel + (size_t)r * V;

  if (MODE == SAMPLE) {
    float bv = 0.f;
    int bi = V;
    for (int i = tid; i < V; i += F_THREADS) {
      const float s = scaled(i);
      const float val = (kept(s) ? s : MASK) + grow[i];
      if (bi == V || val > bv) {
        bv = val;
        bi = i;
      }
    }
    const int tok = block_argmax(bi == V ? -INFINITY : bv, bi, redf, redi);
    if (tid == 0) a.tokens[r] = tok;
    return;
  }

  // Verify: p over the keep set, p_d, the residual and its sample.
  float zk = 0.f;
  for (int i = tid; i < V; i += F_THREADS) {
    const float s = scaled(i);
    if (kept(s)) zk += expf(s - m2);
  }
  const float denom = fmaxf(block_sum(zk, redf), 1e-30f);
  auto prob = [&](int i) -> float {
    const float s = scaled(i);
    return kept(s) ? expf(s - m2) / denom : 0.f;
  };
  const float* qrow = a.q + (size_t)r * V;
  float rs = 0.f;
  for (int i = tid; i < V; i += F_THREADS) rs += fmaxf(prob(i) - qrow[i], 0.f);
  const bool has_mass = block_sum(rs, redf) > 0.f;
  float bv = 0.f;
  int bi = V;
  for (int i = tid; i < V; i += F_THREADS) {
    const float p = prob(i);
    const float res = has_mass ? fmaxf(p - qrow[i], 0.f) : p;
    const float val = (res > 0.f ? logf(fmaxf(res, 1e-38f)) : MASK) + grow[i];
    if (bi == V || val > bv) {
      bv = val;
      bi = i;
    }
  }
  const int bonus = block_argmax(bi == V ? -INFINITY : bv, bi, redf, redi);
  if (tid == 0) {
    a.tokens[r] = greedy;
    a.p_d[r] = prob(a.judge[r]);
    a.bonus[r] = bonus;
  }
}

// ------------------------------------------------------------------- launch

// Opt `kern` into `smem` bytes of dynamic shared memory past the default 48
// KB, once per kernel and size (`*opted` remembers the largest size set), so
// that launches captured in a CUDA graph make no attribute call.
template <typename K>
cudaError_t opt_in(K kern, size_t smem, size_t* opted) {
  if (smem <= 48 * 1024 || smem <= *opted) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *opted = smem;
  return err;
}

template <typename TX, typename TH>
cudaError_t launch_head(const void* x, const void* h, const float* scale, float* logits, int R,
                        int V, int d, cudaStream_t s) {
  static size_t opted[2] = {0, 0};
  const size_t smem = (size_t)RB * d * sizeof(float);
  const dim3 grid((R + RB - 1) / RB, (V + VPB - 1) / VPB);
  const bool vec = d % Vec16<TH>::N == 0 && ((uintptr_t)h) % 16 == 0;
  void (*kern)(const TX*, const TH*, const float*, float*, int, int, int) =
      vec ? &head_logits_kernel<TX, TH, true> : &head_logits_kernel<TX, TH, false>;
  const cudaError_t err = opt_in(kern, smem, &opted[vec]);
  if (err != cudaSuccess) return err;
  kern<<<grid, P_THREADS, smem, s>>>((const TX*)x, (const TH*)h, scale, logits, R, V, d);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_head_x(int head_dtype, const void* x, const void* h, const float* scale,
                          float* logits, int R, int V, int d, cudaStream_t s) {
  if (head_dtype == F32) return launch_head<TX, float>(x, h, nullptr, logits, R, V, d, s);
  if (head_dtype == BF16) return launch_head<TX, __nv_bfloat16>(x, h, nullptr, logits, R, V, d, s);
  if (head_dtype == I8) {
    if (scale == nullptr) return cudaErrorInvalidValue;
    return launch_head<TX, int8_t>(x, h, scale, logits, R, V, d, s);
  }
  return cudaErrorInvalidValue;
}

template <int MODE>
cudaError_t launch_finalize(const FinalizeArgs& a, int R, cudaStream_t s) {
  static int optin = 0;  // the device's shared-memory limit per block
  static size_t opted = 0;
  cudaError_t err;
  if (optin == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  const size_t static_smem = F_WARPS * (sizeof(float) + sizeof(int));
  const size_t smem = (size_t)a.V * sizeof(float);
  if (smem + static_smem <= (size_t)optin) {
    err = opt_in(&finalize_kernel<MODE, true>, smem, &opted);
    if (err != cudaSuccess) return err;
    finalize_kernel<MODE, true><<<R, F_THREADS, smem, s>>>(a);
  } else {
    finalize_kernel<MODE, false><<<R, F_THREADS, 0, s>>>(a);
  }
  return cudaGetLastError();
}

cudaError_t run(int mode, int x_dtype, int head_dtype, const void* x, const void* h,
                const float* scale, float* logits, const FinalizeArgs& a, int R, int d,
                cudaStream_t s) {
  if (R <= 0 || a.V <= 0 || d <= 0 || R > 65535 || (a.V + VPB - 1) / VPB > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (x_dtype == F32) {
    err = launch_head_x<float>(head_dtype, x, h, scale, logits, R, a.V, d, s);
  } else if (x_dtype == BF16) {
    err = launch_head_x<__nv_bfloat16>(head_dtype, x, h, scale, logits, R, a.V, d, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return mode == SAMPLE ? launch_finalize<SAMPLE>(a, R, s) : launch_finalize<VERIFY>(a, R, s);
}

}  // namespace

// x (R, d) in the dtype code's type; head (V, d) of head_dtype (F32, BF16 or
// I8 with scale (V,) float32); temps, top_ps (R,) float32; top_ks (R,)
// int32; gumbel and logits (R, V) float32; tokens (R,) int64.  All
// contiguous.
extern "C" int fused_head_sample_launch(int dtype, const void* x, const void* head,
                                        const void* scale, const void* temps, const void* top_ks,
                                        const void* top_ps, const void* gumbel, void* logits,
                                        void* tokens, int head_dtype, int R, int V, int d,
                                        void* stream) {
  const FinalizeArgs a{(const float*)logits, (const float*)temps, (const int*)top_ks,
                       (const float*)top_ps, (const float*)gumbel, nullptr, nullptr,
                       (long long*)tokens, nullptr, nullptr, V};
  return (int)run(SAMPLE, dtype, head_dtype, x, head, (const float*)scale, (float*)logits, a, R,
                  d, (cudaStream_t)stream);
}

// As fused_head_sample_launch, plus judge (R,) int32 and q (R, V) float32 in,
// greedy (R,) int64, p_d (R,) float32 and bonus (R,) int64 out.
extern "C" int fused_verify_head_launch(int dtype, const void* x, const void* head,
                                        const void* scale, const void* temps, const void* top_ks,
                                        const void* top_ps, const void* judge, const void* q,
                                        const void* gumbel, void* logits, void* greedy, void* p_d,
                                        void* bonus, int head_dtype, int R, int V, int d,
                                        void* stream) {
  const FinalizeArgs a{(const float*)logits, (const float*)temps, (const int*)top_ks,
                       (const float*)top_ps, (const float*)gumbel, (const int*)judge,
                       (const float*)q, (long long*)greedy, (float*)p_d, (long long*)bonus, V};
  return (int)run(VERIFY, dtype, head_dtype, x, head, (const float*)scale, (float*)logits, a, R,
                  d, (cudaStream_t)stream);
}
