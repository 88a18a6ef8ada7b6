// Split-KV (flash-decoding) machinery of the decode attention kernels: one
// block owns one contiguous span of at most MAX_SPAN of one slot's keys for a
// chunk of G query heads, streams the span's K and then its V through
// shared memory in tiles, and the spans of one (slot, kv head, chunk) merge
// in the same launch.
//
// Per block:
//   score_whole / score_general  q . k of each K tile's keys for the G heads,
//                                into the span's score row in shared memory
//   softmax_span                 the span's max m and denominator l, and its
//                                probabilities in place of the scores (log2
//                                units: q carries log2(e) / sqrt(d), the
//                                exponentials are exp2)
//   value_tile                   acc += p V of each V tile, two columns a thread
//   finish_split                 sums the threads' key groups in a fixed
//                                order and either writes the output (the
//                                span held every live key) or stores the
//                                span's (m, l, acc) in its workspace slot; the
//                                block that arrives last among the live spans
//                                (a counter bumped once a block and reset by
//                                that block) merges the slots in split order
//                                and writes the output.
// With the span's scores all in shared memory, the softmax is one pass a
// block (no rescale per tile), so a block's chain of dependent steps is the
// same whatever its span.  No atomics touch the sums, so two calls on the
// same inputs give the same bits, and a call is one launch that allocates
// nothing (the wrapper hands in the workspace and the counters, which are
// zero between calls).
//
// The caller moves the tiles: a bulk copy (cp.async.bulk on an mbarrier,
// a ring of `stages` tiles each for K and V, all issued up front when they
// fit) where rows are whole 16-byte units at a 16-byte aligned base, else
// direct loads by every thread.  A dense cache hands a tile over as one
// contiguous run of rows; a paged pool as one run per pool block (an int8
// pool's per-block scales enter through softmax_span's Scales).

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace port {
namespace decode {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SPAN = 256;          // keys of a block (its scores stay on chip)
constexpr int MAX_TILE = 64;           // keys of a tile
constexpr int TILE_BYTES = 8192;       // bytes of K (and of V) a tile moves, at most
constexpr int MAX_STAGES = 8;          // tiles in flight, each of K and V
constexpr int RING_BYTES = 64 * 1024;  // the K and V rings together, at most
constexpr float LOG2E = 1.4426950408889634f;

// Keys of a tile of rows of `row_bytes`: at most TILE_BYTES of K (and as
// much of V), a power of two from 1 to MAX_TILE.
inline int tile_keys(int row_bytes) {
  int tk = MAX_TILE;
  while (tk > 1 && tk * row_bytes > TILE_BYTES) tk >>= 1;
  return tk;
}

// Tiles in each ring: every tile of a span when the rings fit RING_BYTES,
// else as many as fit (at least one).
inline int ring_stages(int span, int tk, size_t tile_bytes) {
  int stages = (span + tk - 1) / tk;
  const int fit = (int)(RING_BYTES / (2 * tile_bytes));
  if (stages > fit) stages = fit;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  return stages < 1 ? 1 : stages;
}

// Floats of one split's workspace slot: acc (G x D), then m (G), then l (G).
template <int G, int D>
__host__ __device__ constexpr int slot_floats() { return G * (D + 2); }

// Threads of the value pass: COLT threads along a row (two columns each),
// KG key groups side by side.
template <int D>
struct ValueLanes {
  static constexpr int COLT = D / 2;
  static constexpr int KG = THREADS / COLT;
};

// Everything a block keeps in shared memory besides its K/V rings and q.
template <int G>
struct Shared {
  float p[G][MAX_SPAN];         // the span's scores, then its probabilities
  float m[G], l[G];             // the span's max and denominator
  float red[2 * THREADS * G];   // the key groups' accumulators, KG x G x D
  int last;
};

template <typename T>
__device__ __forceinline__ void load_pair(const T* p, float& a, float& b);
template <>
__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
template <>
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a, float& b) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x;
  b = v.y;
}
template <>
__device__ __forceinline__ void load_pair(const int8_t* p, float& a, float& b) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  a = (float)v.x;
  b = (float)v.y;
}

// q of the chunk's heads into q_sh ([G][dt], scaled by qscale; heads past ng
// zero).  Ends with a barrier.
template <typename T>
__device__ __forceinline__ void load_q(const T* qb, int G, int dt, int ng, float qscale,
                                       float* q_sh) {
  for (int i = threadIdx.x; i < G * dt; i += THREADS)
    q_sh[i] = i < ng * dt ? to_f(qb[i]) * qscale : 0.f;
  __syncthreads();
}

// Scores of a tile whose rows are the head dim D itself, into sh.p[g][off +
// key] for key < rows: LPK lanes share a key, each reading whole 16-byte
// chunks of its row, so eight neighbouring lanes read one 128-byte run (no
// bank conflict); the LPK partial sums meet by shuffles.
template <typename T, int D, int G>
__device__ __forceinline__ void score_whole(const T* kt, int rows, int off, const float* q_sh,
                                            Shared<G>& sh) {
  constexpr int E = Vec16<T>::N;
  constexpr int CH = D / E;
  constexpr int LPK = CH < 8 ? CH : 8;
  constexpr int CPL = CH / LPK;
  constexpr int KPW = 32 / LPK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int part = lane % LPK;
  for (int k0 = warp * KPW; k0 < rows; k0 += WARPS * KPW) {
    const int key = k0 + lane / LPK;
    const bool live = key < rows;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (live) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c0 = (part + j * LPK) * E;
        float kv[E];
        load16(kt + key * D + c0, kv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4* qv = reinterpret_cast<const float4*>(q_sh + g * D + c0);
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
#pragma unroll
    for (int sh_off = LPK / 2; sh_off > 0; sh_off >>= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], sh_off);
    }
    if (live && part == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) sh.p[g][off + key] = s[g];
    }
  }
}

// Scores of a tile with rows of any dt elements (a head dim below its
// register width, rows that are not whole 16-byte units, or above 256):
// thread t takes key t of the tile (rows <= MAX_TILE < THREADS) and every
// column.
template <typename T, int G>
__device__ __forceinline__ void score_general(const T* kt, int rows, int off, int dt,
                                              const float* q_sh, Shared<G>& sh) {
  const int key = threadIdx.x;
  if (key >= rows) return;
  float s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) s[g] = 0.f;
  const T* kr = kt + key * dt;
  for (int c = 0; c < dt; ++c) {
    const float kv = to_f(kr[c]);
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] += q_sh[g * dt + c] * kv;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) sh.p[g][off + key] = s[g];
}

// Per-key factors of a span with no scales (dense or float pools).
struct Unscaled {
  static constexpr bool on = false;
  __device__ float k(int) const { return 1.f; }
  __device__ float v(int) const { return 1.f; }
};

// The span's softmax: warp w takes heads w, w + WARPS, ..., lane j the keys
// j, j + 32, ... of the span's n; leaves m, l and the probabilities
// exp2(s - m) in place of the scores.  With scales (an int8 pool), key j's
// score is first multiplied by sc.k(j) and its probability then by sc.v(j);
// l sums the probabilities before that second factor.
template <int G, typename Scales = Unscaled>
__device__ __forceinline__ void softmax_span(int n, Shared<G>& sh, const Scales& sc = Scales()) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += WARPS) {
    float mx = MASK;
    for (int k = lane; k < n; k += 32) {
      float s = sh.p[g][k];
      if constexpr (Scales::on) {
        s *= sc.k(k);
        sh.p[g][k] = s;
      }
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int k = lane; k < n; k += 32) {
      const float e = sm90::fast_exp2(sh.p[g][k] - mx);
      sh.p[g][k] = Scales::on ? e * sc.v(k) : e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      sh.m[g] = mx;
      sh.l[g] = sum;
    }
  }
}

// Value pass of one tile (its keys at off .. off + rows of the span): thread
// t owns columns z0 + 2 (t % COLT) and the next of every head, and the keys
// t / COLT + j KG of the tile.  `whole` rows are D elements with no column
// past the head dim; otherwise rows of dt elements, columns at or past dt
// read as zero.
template <typename T, int D, int G>
__device__ __forceinline__ void value_tile(const T* vt, int rows, int off, int dt, int z0,
                                           bool whole, const Shared<G>& sh, float (&acc)[G][2]) {
  constexpr int COLT = ValueLanes<D>::COLT, KG = ValueLanes<D>::KG;
  const int kg = threadIdx.x / COLT;
  const int c = 2 * (threadIdx.x % COLT);
  if (whole) {
#pragma unroll 4
    for (int key = kg; key < rows; key += KG) {
      float v0, v1;
      load_pair(vt + key * D + c, v0, v1);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sh.p[g][off + key];
        acc[g][0] += p * v0;
        acc[g][1] += p * v1;
      }
    }
  } else {
    const int col = z0 + c;
    for (int key = kg; key < rows; key += KG) {
      const T* vr = vt + key * dt;
      const float v0 = col < dt ? to_f(vr[col]) : 0.f;
      const float v1 = col + 1 < dt ? to_f(vr[col + 1]) : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sh.p[g][off + key];
        acc[g][0] += p * v0;
        acc[g][1] += p * v1;
      }
    }
  }
}

// After the span's last V tile.  `out` is the output row of the chunk's
// first head (head g at out + g dt, columns z0 ..); `slots` the group's
// workspace slots; `counter` the group's arrival counter (zero between calls).
template <typename T, int D, int G>
__device__ __forceinline__ void finish_split(const float (&acc)[G][2], Shared<G>& sh, int split,
                                             int n_live, float* slots, int* counter, T* out,
                                             int dt, int z0, int ng) {
  constexpr int COLT = ValueLanes<D>::COLT, KG = ValueLanes<D>::KG;
  constexpr int SLOT = slot_floats<G, D>();
  const int kg = threadIdx.x / COLT;
  const int c = 2 * (threadIdx.x % COLT);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    sh.red[(kg * G + g) * D + c] = acc[g][0];
    sh.red[(kg * G + g) * D + c + 1] = acc[g][1];
  }
  __syncthreads();
  if (n_live == 1) {  // the span held every live key: no merge
    for (int i = threadIdx.x; i < G * D; i += THREADS) {
      const int g = i / D, cc = i % D;
      if (g >= ng || z0 + cc >= dt) continue;
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < KG; ++j) a += sh.red[(j * G + g) * D + cc];
      out[g * dt + z0 + cc] = from_f<T>(a / fmaxf(sh.l[g], 1e-30f));
    }
    return;
  }
  float* slot = slots + (size_t)split * SLOT;
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, cc = i % D;
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < KG; ++j) a += sh.red[(j * G + g) * D + cc];
    slot[i] = a;
  }
  if (threadIdx.x < G) {
    slot[G * D + threadIdx.x] = sh.m[threadIdx.x];
    slot[G * D + G + threadIdx.x] = sh.l[threadIdx.x];
  }
  // The block's stores, then its arrival, one acquire-release atomic after
  // the barrier (release: cumulative over the block's stores; acquire: the
  // last to arrive sees every other block's, and the barrier passes that on
  // to its threads).
  __syncthreads();
  if (threadIdx.x == 0) {
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(before) : "l"(counter) : "memory");
    sh.last = before == n_live - 1;
  }
  __syncthreads();
  if (!sh.last) return;
  // The last span merges every live slot in split order, one pass with a
  // running max.  Thread t takes elements t, t + THREADS, ... (ET of them)
  // and issues the loads of SB slots for all of them together (L2 reads:
  // the other blocks' stores are not in this SM's L1).
  constexpr int ET = (G * D + THREADS - 1) / THREADS;
  constexpr int SB = ET >= 16 ? 1 : 16 / ET;
  float mx[ET], den[ET], num[ET];
#pragma unroll
  for (int e = 0; e < ET; ++e) mx[e] = MASK, den[e] = num[e] = 0.f;
  for (int s0 = 0; s0 < n_live; s0 += SB) {
    float ms[SB][ET], ls[SB][ET], as[SB][ET];
#pragma unroll
    for (int j = 0; j < SB; ++j) {
#pragma unroll
      for (int e = 0; e < ET; ++e) {
        const int i = threadIdx.x + e * THREADS;
        if (s0 + j < n_live && i < G * D) {
          const float* sl = slots + (s0 + j) * SLOT;
          ms[j][e] = __ldcg(sl + G * D + i / D);
          ls[j][e] = __ldcg(sl + G * D + G + i / D);
          as[j][e] = __ldcg(sl + i);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SB; ++j) {
#pragma unroll
      for (int e = 0; e < ET; ++e) {
        if (s0 + j < n_live && threadIdx.x + e * THREADS < G * D) {
          const float mn = fmaxf(mx[e], ms[j][e]);
          const float f_old = sm90::fast_exp2(mx[e] - mn), f_new = sm90::fast_exp2(ms[j][e] - mn);
          den[e] = den[e] * f_old + ls[j][e] * f_new;
          num[e] = num[e] * f_old + as[j][e] * f_new;
          mx[e] = mn;
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < ET; ++e) {
    const int i = threadIdx.x + e * THREADS, g = i / D, cc = i % D;
    if (i < G * D && g < ng && z0 + cc < dt)
      out[g * dt + z0 + cc] = from_f<T>(num[e] / fmaxf(den[e], 1e-30f));
  }
  if (threadIdx.x == 0) *counter = 0;
}

}  // namespace decode
}  // namespace port
