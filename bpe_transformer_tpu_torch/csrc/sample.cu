// The decode tick's tail (head projection, top-k/top-p filter, gumbel sample)
// and the speculative verify tail, each as a head-projection kernel followed
// by a finalize kernel of one thread block cluster per row.
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
// Design.  (a) The projection.  bf16 rows against a bf16 or int8 head with
// d % 16 == 0 (the wrapper's head_path) run on the tensor cores:
// weight_gemm.cuh's y^T = h x^T, the head rows the 64-row M side and the R
// hidden rows the N side rounded up to a multiple of 8 (40 rows run as N
// 40), an int8 head widened exactly to bf16 by a byte permute and its row
// scale applied in the epilogue; the products are exact in float32, only
// the order of the float32 sums differs from the CUDA-core kernel's.
// Everything else (float32 rows, which must keep float32 accuracy; a float32
// head, rounded to bf16 on load; rows TMA cannot describe) runs
// head_logits_kernel on the CUDA cores: a block holds 8 hidden rows in
// shared memory as float32 against 64 head rows, each warp 4 head rows at a
// time with 16-byte loads along the reduction axis.
// (b) finalize_kernel: one cluster of C blocks of 512 threads per row (C up
// to 8, so that R C blocks fit two to an SM: 8 rows x 8, 40 rows x 6); block
// c of a cluster owns columns [c chunk, (c + 1) chunk) of the row, scaled (a
// true division, as the plain version divides) into its shared memory.  The blocks merge
// their partial results through distributed shared memory: each writes its
// own, the cluster synchronises, and every block reads all of them in the
// same order, so every block takes the same decisions.  The filter finds
// the TPU kernel's thresholds over order-preserving uint32 keys by radix
// select, 8-bit digits from the top: the top-k threshold (the largest key t
// with count(keys >= t) >= k, the k-th largest key) in 4 count-histogram
// passes, the nucleus threshold (the smallest t whose kept mass strictly
// above it is below top_p times the kept mass) in 4 mass-histogram passes,
// the first of which also gives the kept mass.  Both are exact key values
// with the definitions of the bit-by-bit descent they replace, so the top-k
// keep set is filter_logits' exactly; the nucleus mass is summed as 64-bit
// integers of 2^-32 (each weight exp(s - max) <= 1 rounded once, far below
// a float32 ulp of the mass, which is >= 1), exact and so independent of
// the order, where the plain version sums a sorted float32 cumsum: a logit
// within an ulp of the nucleus edge may flip.  In a histogram pass each warp
// adds into its own histogram, so no two warps contend: a count is a native
// 32-bit shared atomic a column, while masses (64-bit shared atomics are
// compare-and-swap loops) are summed over the lanes of one digit first
// (__match_any_sync, __reduce_add_sync) and added by one atomic.  The block
// sums its warps' histograms, and every block pulls the cluster's bins with
// all their loads in flight together.  All integers, so no sum depends on
// the order.  Top-k's first pass rides on the scaling pass and its
// exchange.  Once at most 512 keys lie at or above the top-k digits found
// so far (with k 50, after the second digit as a rule), the blocks instead
// gather those columns into each block after one more cluster barrier and
// finish the row on them alone: the top-k threshold is the key with fewer
// than k keys above it and at least k at or above it, the nucleus threshold
// the least kept key whose mass above is below top_p z (the same integers,
// one thread a column), and the sample, the denominator (summed in (key,
// index) order), the residual and the bonus need nothing outside the set,
// since every other column has p = 0.  That saves the later top-k passes,
// the four nucleus passes and their barriers.  A disabled
// top-k skips its passes, as does a nucleus that keeps everything; temp 0
// rows take the raw argmax and skip the filter (for verify their p is the
// exact one-hot, so p_d is the argmax agreement and the bonus the argmax
// itself).  Float sums (the verify denominator and residual mass) reduce
// per thread, then a warp tree, then the block's warps, then the cluster's
// blocks, in a fixed order, so results repeat bit for bit.  Loops over
// device memory (the logits, the gumbel and q rows) load UNROLL columns a
// thread before using any.
//
// Built without --use_fast_math: expf, logf and the division are IEEE.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "weight_gemm.cuh"

using namespace port;
namespace cg = cooperative_groups;

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

constexpr int F_THREADS = 512;
constexpr int F_WARPS = F_THREADS / 32;
constexpr int MAX_CLUSTER = 8;
constexpr int UNROLL = 4;                  // columns a thread loads at once from device memory
constexpr int CAP = F_THREADS;             // the most kept columns the small-set finish takes
constexpr int BINS = 256;                  // one 8-bit digit
constexpr float FIXED_ONE = 4294967296.f;  // a weight of 1 in the mass sums' fixed point
constexpr int SAMPLE = 0;
constexpr int VERIFY = 1;
constexpr unsigned FULL = 0xffffffffu;

// f32 -> uint32 whose unsigned order is the float order (NaN-free inputs).
__device__ __forceinline__ unsigned okey(float x) {
  const unsigned b = __float_as_uint(x);
  return (b >> 31) ? ~b : (b | 0x80000000u);
}

// (value, index) with the larger value, the smaller index on ties.
__device__ __forceinline__ void arg_merge(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    arg_merge(v, i, __shfl_xor_sync(FULL, v, off), __shfl_xor_sync(FULL, i, off));
}

// Block-wide reductions: every thread returns the same value, reduced in a
// fixed order.  `red` holds F_WARPS entries; the leading barrier protects it
// from the previous reduction's readers.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(lane < F_WARPS ? red[lane] : 0.f);
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_max(lane < F_WARPS ? red[lane] : -INFINITY);
}

__device__ unsigned block_min(unsigned v, int* red) {
  const int lane = threadIdx.x & 31;
  v = __reduce_min_sync(FULL, v);
  __syncthreads();
  if (lane == 0) red[threadIdx.x >> 5] = (int)v;
  __syncthreads();
  return __reduce_min_sync(FULL, lane < F_WARPS ? (unsigned)red[lane] : 0xffffffffu);
}

__device__ void block_argmax(float& v, int& i, float* redf, int* redi) {
  const int lane = threadIdx.x & 31;
  warp_argmax(v, i);
  __syncthreads();
  if (lane == 0) {
    redf[threadIdx.x >> 5] = v;
    redi[threadIdx.x >> 5] = i;
  }
  __syncthreads();
  v = lane < F_WARPS ? redf[lane] : -INFINITY;
  i = lane < F_WARPS ? redi[lane] : 0x7fffffff;
  warp_argmax(v, i);
}

// What the blocks of a cluster hand each other, double-buffered by the
// parity of the exchange (a buffer is rewritten only after every block has
// passed the next cluster barrier, i.e. finished reading it), the cluster's
// histogram of the last radix pass, and each warp's own histogram of the
// pass (so that no two warps add to one bin).
struct Exchange {
  unsigned long long hist[2][BINS];  // this block's counts or masses of a radix pass
  unsigned long long merged[BINS];   // the cluster's, summed over its blocks
  union {
    unsigned long long warp_hist[F_WARPS][BINS];  // a mass pass
    unsigned warp_count[F_WARPS][BINS];           // a count pass
    struct {  // a small keep set: this block's kept columns, then the cluster's
      float s[CAP];
      int idx[CAP];
      int all_idx[CAP];
      unsigned all_key[CAP];
      unsigned long long all_w[CAP];
      float sorted[CAP];
      int count;
    } keep;
  };
  float f[2][4];
  int i[2][4];
};

// Add the mass `w` (fixed point) to bin `digit` of the warp's histogram `h`
// (BINS: nothing), the lanes of one digit summed first and added by one
// atomic: every lane calls it.
__device__ __forceinline__ void mass_add(unsigned long long* h, unsigned digit,
                                         unsigned long long w) {
  if (!__any_sync(FULL, digit < BINS)) return;  // (the same in every lane)
  const unsigned peers = __match_any_sync(FULL, digit);
  // Masses are at most 2^32: their 16-bit halves sum in 32 bits.
  const unsigned hi = __reduce_add_sync(peers, (unsigned)(w >> 16));
  const unsigned lo = __reduce_add_sync(peers, (unsigned)(w & 0xFFFFu));
  if (digit < BINS && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&h[digit], ((unsigned long long)hi << 16) + lo);
}

// Every warp: lane l's bins 8 l .. 8 l + 7 of the merged histogram as `h`,
// the sum of the bins of the lanes above as `higher`; returns the total.
__device__ __forceinline__ unsigned long long lane_bins(const unsigned long long* merged,
                                                        unsigned long long (&h)[8],
                                                        unsigned long long& higher) {
  const int lane = threadIdx.x & 31;
  unsigned long long mine = 0ull;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    h[q] = merged[8 * lane + q];
    mine += h[q];
  }
  unsigned long long suffix = mine;  // sum over lanes >= lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long t = __shfl_down_sync(FULL, suffix, off);
    if (lane + off < 32) suffix += t;
  }
  higher = suffix - mine;
  return __shfl_sync(FULL, suffix, 0);
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
  int chunk;  // columns a block of a row's cluster owns
};

template <int MODE, bool SMEM>
__global__ void __launch_bounds__(F_THREADS, 2) finalize_kernel(FinalizeArgs a) {
  extern __shared__ __align__(16) float smem_row[];  // the block's scaled columns when SMEM
  __shared__ Exchange smem_xc;
  __shared__ float smem_redf[F_WARPS];
  __shared__ int smem_redi[F_WARPS];
  // Plain references to the shared objects, for the lambdas below.
  float* const srow = smem_row;
  Exchange& xc = smem_xc;
  float* const redf = smem_redf;
  int* const redi = smem_redi;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int V = a.V;
  const int r = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = rank * a.chunk;
  const int n = max(0, min(V, c0 + a.chunk) - c0);  // this block's columns
  const int iters = (a.chunk + F_THREADS - 1) / F_THREADS;  // the same in every block
  const float* lrow = a.logits + (size_t)r * V;
  const float temp = a.temps[r];
  const bool sampled = temp > 0.f;
  const float tdiv = fmaxf(temp, 1e-6f);
  int ph = 0;  // exchanges so far

  // The cluster barrier of an exchange: returns the buffer it published.
  auto exchange = [&]() -> int {
    cl.sync();
    return ph++ & 1;
  };
  // Every warp: the blocks' values of slot j of buffer b, merged.
  auto cluster_sum = [&](int b, int j) {
    return warp_sum(lane < C ? cl.map_shared_rank(xc.f[b], lane)[j] : 0.f);
  };
  auto cluster_max = [&](int b, int j) {
    return warp_max(lane < C ? cl.map_shared_rank(xc.f[b], lane)[j] : -INFINITY);
  };
  auto cluster_argmax = [&](int b, int j) {
    float v = lane < C ? cl.map_shared_rank(xc.f[b], lane)[j] : -INFINITY;
    int i = lane < C ? cl.map_shared_rank(xc.i[b], lane)[j] : 0x7fffffff;
    warp_argmax(v, i);
    return i;
  };
  // After a radix pass's exchange: the cluster's histogram into xc.merged,
  // thread t < BINS summing bin t over the blocks with all their loads in
  // flight together.
  auto pull = [&](int b) {
    if (tid < BINS) {
      unsigned long long v[MAX_CLUSTER];
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c)
        v[c] = c < C ? cl.map_shared_rank(xc.hist[b], c)[tid] : 0ull;
      unsigned long long sum = 0ull;
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c) sum += v[c];
      xc.merged[tid] = sum;
    }
    __syncthreads();
  };
  // The block's histogram of a pass into buffer b: its warps' summed in a
  // fixed order (and cleared for the next pass).
  auto merge = [&](auto mass, int b) {
    if (tid < BINS) {
      unsigned long long sum = 0ull;
#pragma unroll
      for (int wp = 0; wp < F_WARPS; ++wp) {
        if constexpr (decltype(mass)::value) {
          sum += xc.warp_hist[wp][tid];
          xc.warp_hist[wp][tid] = 0ull;
        } else {
          sum += xc.warp_count[wp][tid];
          xc.warp_count[wp][tid] = 0u;
        }
      }
      xc.hist[b][tid] = sum;
    }
  };
  auto merge_counts = [&](int b) { merge(std::false_type{}, b); };
  for (int i = tid; i < F_WARPS * BINS; i += F_THREADS) (&xc.warp_hist[0][0])[i] = 0ull;
  __syncthreads();
  const int topk = a.top_ks[r];
  const long long kk = topk > 0 ? min(topk, V) : V;
  const bool topk_on = sampled && kk < V;
  // Pass 1: the raw argmax (first occurrence), the scaled columns, and with
  // top-k on the count histogram of the keys' top digit (top-k's first
  // radix pass, published by the same exchange); the loads of UNROLL
  // columns a thread in flight together.
  float best = -INFINITY, smax = -INFINITY;
  int bidx = 0x7fffffff;
  for (int i0 = tid; i0 < n; i0 += UNROLL * F_THREADS) {
    float lv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * F_THREADS;
      lv[u] = i < n ? lrow[c0 + i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * F_THREADS;
      if (i >= n) break;
      const float l = lv[u];
      if (bidx == 0x7fffffff || l > best) {
        best = l;
        bidx = c0 + i;
      }
      if (sampled) {
        const float s = l / tdiv;
        smax = fmaxf(smax, s);
        if (SMEM) srow[i] = s;
        if (topk_on) atomicAdd(&xc.warp_count[warp][okey(s) >> 24], 1u);
      }
    }
  }
  block_argmax(best, bidx, redf, redi);
  smax = block_max(smax, redf);
  if (topk_on) merge_counts(0);
  if (tid == 0) {
    xc.f[0][0] = best;
    xc.i[0][0] = bidx;
    xc.f[0][1] = smax;
  }
  int b = exchange();
  const int greedy = cluster_argmax(b, 0);
  const float m2 = cluster_max(b, 1);  // the row max is always kept
  if (!sampled) {
    if (rank == 0 && tid == 0) {
      a.tokens[r] = greedy;
      if (MODE == VERIFY) {
        a.p_d[r] = a.judge[r] == greedy ? 1.f : 0.f;
        a.bonus[r] = greedy;
      }
    }
    cl.sync();  // no block leaves while another may read its shared memory
    return;
  }
  __syncthreads();  // srow, and the cleared warp histograms
  auto scaled = [&](int i) -> float { return SMEM ? srow[i] : lrow[c0 + i] / tdiv; };

  // One radix pass: every thread adds its columns whose key matches
  // `prefix` above bit shift + 8 (and passes `keep`) to its warp's
  // histogram of their digit at `shift`; the warps' histograms are summed
  // in a fixed order into the block's, and the cluster exchanges.  Returns
  // the buffer.
  auto radix_pass = [&](auto mass, unsigned prefix, int shift, auto keep) -> int {
    unsigned long long* h = xc.warp_hist[warp];
#pragma unroll 4
    for (int j = 0; j < iters; ++j) {
      const int i = tid + j * F_THREADS;
      unsigned digit = BINS;
      unsigned long long w = 0ull;
      if (i < n) {
        const float s = scaled(i);
        const unsigned k = okey(s);
        if (keep(k) && (shift == 24 || (k >> (shift + 8)) == (prefix >> (shift + 8)))) {
          digit = (k >> shift) & (BINS - 1);
          if constexpr (decltype(mass)::value)
            w = (unsigned long long)__float2ull_rn(expf(s - m2) * FIXED_ONE);
        }
      }
      if constexpr (decltype(mass)::value) {
        mass_add(h, digit, w);
      } else if (digit < BINS) {
        atomicAdd(&xc.warp_count[warp][digit], 1u);  // native 32-bit shared atomic
      }
    }
    __syncthreads();
    merge(mass, ph & 1);
    return exchange();
  };

  // Top-k: the largest key t with count(keys >= t) >= k, digit by digit.
  // Every warp takes the same decisions from the merged histogram.  Once at
  // most CAP keys lie at or above the digits found so far, the passes stop
  // and the small-set finish below ranks those keys instead.
  unsigned tk = 0u;  // k == V keeps everything, as the least key would
  unsigned long long n_ge = V;  // keys >= tk
  bool tk_exact = true;  // else tk holds the top digits only
  if (topk_on) {
    unsigned long long above = 0ull;  // keys above the pass's prefix
    for (int shift = 24; shift >= 0; shift -= 8) {
      // The first digit's histogram came with pass 1's exchange (buffer 0).
      pull(shift == 24 ? 0 : radix_pass(std::false_type{}, tk, shift, [](unsigned) { return true; }));
      unsigned long long h[8], higher;
      lane_bins(xc.merged, h, higher);
      // S(d) = count of the pass's keys with digit >= d; the digit is the
      // largest d with above + S(d) >= k.
      int cand = -1;
      unsigned long long s_at = 0ull, s_after = 0ull, run = higher;
#pragma unroll
      for (int q = 7; q >= 0; --q) {
        const unsigned long long after = run;
        run += h[q];
        if (cand < 0 && above + run >= (unsigned long long)kk) {
          cand = 8 * lane + q;
          s_at = run;
          s_after = after;
        }
      }
      const int d = __reduce_max_sync(FULL, cand);
      n_ge = above + __shfl_sync(FULL, s_at, d >> 3);
      above += __shfl_sync(FULL, s_after, d >> 3);
      tk |= (unsigned)d << shift;
      if (shift > 0 && n_ge <= CAP) {
        tk_exact = false;
        break;
      }
    }
  }

  const double top_p = a.top_ps[r];
  if (n_ge <= CAP) {
    // A small keep set (top-k on, or a small vocabulary): every block
    // gathers the cluster's columns with key >= tk (every key top-k can
    // keep) and finishes the row on them alone, with no cluster barrier but
    // the last.  Every result below is a function of that set: outside it p
    // is 0, the sample's score is MASK, and nothing adds mass.
    auto& kp = xc.keep;
    if (tid == 0) kp.count = 0;
    __syncthreads();
    for (int i = tid; i < n; i += F_THREADS) {
      const float s = scaled(i);
      if (okey(s) >= tk) {
        const int slot = atomicAdd(&kp.count, 1);  // any order: the set is what counts
        kp.s[slot] = s;
        kp.idx[slot] = c0 + i;
      }
    }
    exchange();
    // Thread t takes the cluster's kept column t (blocks in rank order).
    int total = 0, src = -1, off = 0;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      const int cnt = c < C ? *cl.map_shared_rank(&kp.count, c) : 0;
      if (src < 0 && tid < total + cnt) {
        src = c;
        off = tid - total;
      }
      total += cnt;
    }
    float s_t = 0.f;
    unsigned key_t = 0u;
    unsigned long long w_t = 0ull;
    int idx_t = 0x7fffffff;
    if (src >= 0) {
      s_t = cl.map_shared_rank(kp.s, src)[off];
      idx_t = cl.map_shared_rank(kp.idx, src)[off];
      key_t = okey(s_t);
      w_t = (unsigned long long)__float2ull_rn(expf(s_t - m2) * FIXED_ONE);
      kp.all_key[tid] = key_t;
      kp.all_w[tid] = w_t;
      kp.all_idx[tid] = idx_t;
    }
    __syncthreads();
    if (!tk_exact) {
      // The k-th largest key: the one with fewer than k keys above it and
      // at least k at or above it.
      int gt = 0, ge = 0;
      for (int j = 0; j < total; ++j) {
        const unsigned kj = kp.all_key[j];
        gt += kj > key_t;
        ge += kj >= key_t;
      }
      tk = block_min(src >= 0 && gt < kk && kk <= ge ? key_t : 0xffffffffu, redi);
    }
    // The top-k set's mass z, the mass strictly above each key, and each
    // column's place in (key descending, index ascending) order.
    unsigned long long z = 0ull, above_t = 0ull;
    int place = 0;
    for (int j = 0; j < total; ++j) {
      const unsigned kj = kp.all_key[j];
      const unsigned long long wj = kj >= tk ? kp.all_w[j] : 0ull;
      z += wj;
      above_t += kj > key_t ? wj : 0ull;
      place += kj > key_t || (kj == key_t && kp.all_idx[j] < idx_t);
    }
    // Nucleus, as the radix passes define it: the least key whose mass
    // above is below top_p z, or 0 when z itself is.
    const double p_mass = top_p * (double)z;
    const bool in_t = src >= 0 && key_t >= tk;
    const unsigned tp = (double)z < p_mass
        ? 0u : block_min(in_t && (double)above_t < p_mass ? key_t : 0xffffffffu, redi);
    const bool kept_t = in_t && (key_t >= tp || s_t == m2);
    const float g_t = src >= 0 ? a.gumbel[(size_t)r * V + idx_t] : 0.f;
    if (MODE == SAMPLE) {
      float v = kept_t ? s_t + g_t : -INFINITY;
      int i = kept_t ? idx_t : 0x7fffffff;
      block_argmax(v, i, redf, redi);
      if (rank == 0 && tid == 0) a.tokens[r] = i;
    } else {
      // The denominator summed in the set's order, so it repeats.
      const float e_t = kept_t ? expf(s_t - m2) : 0.f;
      if (src >= 0) kp.sorted[place] = e_t;
      __syncthreads();
      const float denom = fmaxf(block_sum(tid < total ? kp.sorted[tid] : 0.f, redf), 1e-30f);
      const float p = e_t / denom;
      const float res = src >= 0 ? fmaxf(p - a.q[(size_t)r * V + idx_t], 0.f) : 0.f;
      const bool has_mass = __syncthreads_or(res > 0.f);
      const float base = has_mass ? res : p;
      float v = base > 0.f ? logf(fmaxf(base, 1e-38f)) + g_t : -INFINITY;
      int i = base > 0.f ? idx_t : 0x7fffffff;
      block_argmax(v, i, redf, redi);
      if (rank == 0 && tid == 0) {
        const float sj = lrow[a.judge[r]] / tdiv;
        const unsigned kj = okey(sj);
        a.tokens[r] = greedy;
        a.p_d[r] = kj >= tk && (kj >= tp || sj == m2) ? expf(sj - m2) / denom : 0.f;
        a.bonus[r] = i;
      }
    }
    cl.sync();  // no block leaves while another may read its kept columns
    return;
  }

  // Nucleus: the smallest t whose kept mass strictly above it is below
  // top_p * z, z the kept mass (the first pass's total).  When even t = 0
  // (every key above it) passes, the threshold is 0.
  unsigned tp = 0u;
  double p_mass = 0.0;
  unsigned long long above_m = 0ull;  // kept mass above the pass's prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    pull(radix_pass(std::true_type{}, tp, shift, [tk](unsigned k) { return k >= tk; }));
    unsigned long long h[8], higher;
    const unsigned long long z = lane_bins(xc.merged, h, higher);
    if (shift == 24) {
      p_mass = top_p * (double)z;
      if ((double)z < p_mass) break;  // tp = 0
    }
    // T(d) = mass of the pass's keys with digit > d; the digit is the
    // smallest d with above + T(d) < top_p z (255 when none is).
    int cand = BINS;
    unsigned long long t_at = 0ull, run = higher;
#pragma unroll
    for (int q = 7; q >= 0; --q) {
      if ((double)(above_m + run) < p_mass) {
        cand = 8 * lane + q;
        t_at = run;
      }
      run += h[q];
    }
    const int d = __reduce_min_sync(FULL, cand);
    if (d < BINS) above_m += __shfl_sync(FULL, t_at, d >> 3);
    tp |= (unsigned)(d < BINS ? d : BINS - 1) << shift;
  }
  // The max and its value ties always survive.
  auto kept = [&](float s) -> bool {
    const unsigned k = okey(s);
    return k >= tk && (k >= tp || s == m2);
  };
  const float* grow = a.gumbel + (size_t)r * V + c0;

  if (MODE == SAMPLE) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int i0 = tid; i0 < n; i0 += UNROLL * F_THREADS) {
      float gv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * F_THREADS;
        gv[u] = i < n ? grow[i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * F_THREADS;
        if (i >= n) break;
        const float s = scaled(i);
        const float val = (kept(s) ? s : MASK) + gv[u];
        if (bi == 0x7fffffff || val > bv) {
          bv = val;
          bi = c0 + i;
        }
      }
    }
    block_argmax(bv, bi, redf, redi);
    if (tid == 0) {
      xc.f[ph & 1][0] = bv;
      xc.i[ph & 1][0] = bi;
    }
    b = exchange();
    const int tok = cluster_argmax(b, 0);
    if (rank == 0 && tid == 0) a.tokens[r] = tok;
    cl.sync();
    return;
  }

  // Verify: p over the keep set, p_d, the residual and its sample.
  float zk = 0.f;
#pragma unroll 4
  for (int i = tid; i < n; i += F_THREADS) {
    const float s = scaled(i);
    if (kept(s)) zk += expf(s - m2);
  }
  zk = block_sum(zk, redf);
  if (tid == 0) xc.f[ph & 1][0] = zk;
  b = exchange();
  const float denom = fmaxf(cluster_sum(b, 0), 1e-30f);
  auto prob_of = [&](float s) -> float { return kept(s) ? expf(s - m2) / denom : 0.f; };
  // One pass: the residual's mass, the gumbel argmax of the residual, and
  // that of p (the bonus when the residual has no mass).
  const float* qrow = a.q + (size_t)r * V + c0;
  float rs = 0.f, v_res = -INFINITY, v_p = -INFINITY;
  int i_res = 0x7fffffff, i_p = 0x7fffffff;
  for (int i0 = tid; i0 < n; i0 += UNROLL * F_THREADS) {
    float qv[UNROLL], gv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * F_THREADS;
      qv[u] = i < n ? qrow[i] : 0.f;
      gv[u] = i < n ? grow[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * F_THREADS;
      if (i >= n) break;
      const float p = prob_of(scaled(i));
      const float res = fmaxf(p - qv[u], 0.f);
      rs += res;
      const float vr = (res > 0.f ? logf(fmaxf(res, 1e-38f)) : MASK) + gv[u];
      const float vp = (p > 0.f ? logf(fmaxf(p, 1e-38f)) : MASK) + gv[u];
      if (i_res == 0x7fffffff || vr > v_res) {
        v_res = vr;
        i_res = c0 + i;
      }
      if (i_p == 0x7fffffff || vp > v_p) {
        v_p = vp;
        i_p = c0 + i;
      }
    }
  }
  rs = block_sum(rs, redf);
  block_argmax(v_res, i_res, redf, redi);
  block_argmax(v_p, i_p, redf, redi);
  if (tid == 0) {
    xc.f[ph & 1][0] = rs;
    xc.f[ph & 1][1] = v_res;
    xc.i[ph & 1][1] = i_res;
    xc.f[ph & 1][2] = v_p;
    xc.i[ph & 1][2] = i_p;
  }
  b = exchange();
  const bool has_mass = cluster_sum(b, 0) > 0.f;
  const int bonus = has_mass ? cluster_argmax(b, 1) : cluster_argmax(b, 2);
  if (rank == 0 && tid == 0) {
    a.tokens[r] = greedy;
    a.p_d[r] = prob_of(lrow[a.judge[r]] / tdiv);
    a.bonus[r] = bonus;
  }
  cl.sync();
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
cudaError_t launch_finalize(const FinalizeArgs& a, int R, int C, cudaStream_t s) {
  static int optin = 0;  // the device's shared-memory limit per block
  static size_t opted[2] = {0, 0};
  cudaError_t err;
  if (optin == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  const size_t static_smem = sizeof(Exchange) + F_WARPS * (sizeof(float) + sizeof(int));
  const size_t row = (size_t)a.chunk * sizeof(float);
  const bool smem = row + static_smem <= (size_t)optin;
  void (*kern)(FinalizeArgs) = smem ? &finalize_kernel<MODE, true> : &finalize_kernel<MODE, false>;
  const size_t dyn = smem ? row : 0;
  if (dyn > opted[smem]) {  // past what the static part leaves of the default 48 KB
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return err;
    opted[smem] = dyn;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * C);
  cfg.blockDim = dim3(F_THREADS);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// bn > 0: the tensor-core projection with bn hidden rows a block (bf16 x,
// a bf16 or int8 head, d % 16 == 0); 0: the CUDA-core kernel.
cudaError_t run(int mode, int x_dtype, int head_dtype, const void* x, const void* h,
                const float* scale, float* logits, const FinalizeArgs& a, int R, int d, int bn,
                int cluster, cudaStream_t s) {
  if (R <= 0 || a.V <= 0 || d <= 0 || R > 65535 || (a.V + VPB - 1) / VPB > 65535 ||
      cluster < 1 || cluster > MAX_CLUSTER || (long long)R * cluster > 0x7fffffff ||
      a.chunk <= 0 || (long long)a.chunk * cluster < a.V)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (bn > 0) {
    if (x_dtype != BF16 || d % 16 || (head_dtype != BF16 && head_dtype != I8) ||
        (head_dtype == I8 && scale == nullptr))
      return cudaErrorInvalidValue;
    const int steps = (d + wgemm::KS - 1) / wgemm::KS;
    err = head_dtype == I8
              ? wgemm::launch<int8_t>(bn, x, h, scale, nullptr, logits, R, a.V, d, 1, steps, s)
              : wgemm::launch<__nv_bfloat16>(bn, x, h, nullptr, nullptr, logits, R, a.V, d, 1,
                                             steps, s);
  } else if (x_dtype == F32) {
    err = launch_head_x<float>(head_dtype, x, h, scale, logits, R, a.V, d, s);
  } else if (x_dtype == BF16) {
    err = launch_head_x<__nv_bfloat16>(head_dtype, x, h, scale, logits, R, a.V, d, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return mode == SAMPLE ? launch_finalize<SAMPLE>(a, R, cluster, s)
                        : launch_finalize<VERIFY>(a, R, cluster, s);
}

}  // namespace

// x (R, d) in the dtype code's type; head (V, d) of head_dtype (F32, BF16 or
// I8 with scale (V,) float32); temps, top_ps (R,) float32; top_ks (R,)
// int32; gumbel and logits (R, V) float32; tokens (R,) int64.  All
// contiguous.  bn: the tensor-core projection's hidden rows a block (a
// multiple of 8 up to 64), or 0 for the CUDA-core kernel; the finalize runs
// one cluster of `cluster` blocks (1 to 8) a row, `chunk` columns a block.
extern "C" int fused_head_sample_launch(int dtype, const void* x, const void* head,
                                        const void* scale, const void* temps, const void* top_ks,
                                        const void* top_ps, const void* gumbel, void* logits,
                                        void* tokens, int head_dtype, int R, int V, int d, int bn,
                                        int cluster, int chunk, void* stream) {
  const FinalizeArgs a{(const float*)logits, (const float*)temps, (const int*)top_ks,
                       (const float*)top_ps, (const float*)gumbel, nullptr, nullptr,
                       (long long*)tokens, nullptr, nullptr, V, chunk};
  return (int)run(SAMPLE, dtype, head_dtype, x, head, (const float*)scale, (float*)logits, a, R,
                  d, bn, cluster, (cudaStream_t)stream);
}

// As fused_head_sample_launch, plus judge (R,) int32 and q (R, V) float32 in,
// greedy (R,) int64, p_d (R,) float32 and bonus (R,) int64 out.
extern "C" int fused_verify_head_launch(int dtype, const void* x, const void* head,
                                        const void* scale, const void* temps, const void* top_ks,
                                        const void* top_ps, const void* judge, const void* q,
                                        const void* gumbel, void* logits, void* greedy, void* p_d,
                                        void* bonus, int head_dtype, int R, int V, int d, int bn,
                                        int cluster, int chunk, void* stream) {
  const FinalizeArgs a{(const float*)logits, (const float*)temps, (const int*)top_ks,
                       (const float*)top_ps, (const float*)gumbel, (const int*)judge,
                       (const float*)q, (long long*)greedy, (float*)p_d, (long long*)bonus, V,
                       chunk};
  return (int)run(VERIFY, dtype, head_dtype, x, head, (const float*)scale, (float*)logits, a, R,
                  d, bn, cluster, (cudaStream_t)stream);
}
