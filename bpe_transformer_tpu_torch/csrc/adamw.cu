// Global-norm gradient clipping and AdamW over a whole parameter tree, in
// two launches: the gradients' sum of squares, then the clip and the update.
//
// Replaces no Pallas kernel: the JAX package leaves its clip
// (bpe_transformer_tpu/ops/grad.py clip_by_global_norm) and its AdamW
// (bpe_transformer_tpu/optim/adamw.py adamw_update) to XLA, which fuses each
// leaf's elementwise update into one loop.  Eager PyTorch has no such fusion:
// the plain per-leaf loop (kernels/adamw.py adamw_plain, clip_plain) issues
// about 16 launches a leaf, some 1,800 a step at GPT2_SMALL_32K's 111 leaves,
// and the host's time issuing them, not the card's, paced the training step.
//
// Computes, element by element in float32 (every product, sum, quotient and
// root a rounded intrinsic in the plain loop's order, so nvcc contracts
// nothing into an FMA):
//   q     = max_norm / (norm + 1e-6),   scale = q > 1 ? 1 : q
//   g     = round_to_g_dtype(g * scale)
//   m     = m b1 + g (1 - b1)
//   v     = v b2 + (g g) (1 - b2)
//   upd   = (m / bias1) / (sqrt(v / bias2) + eps)
//   new   = round_to_p_dtype(p decay - lr upd),   decay = 1 - lr wd
// with norm = sqrt of the sum of every gradient element's square.  The
// scalars come from the host, computed in double and rounded to float32 as
// PyTorch rounds a Python scalar: nothing is read back from the card.
//
// Bound on the H100: bytes.  The update reads p, g, m, v and writes p, m, v:
// 28 bytes a float32 parameter, 3.75 GB at GPT2_SMALL_32K's 134.1M, 1.12 ms
// at 3.35 TB/s; the sum of squares reads g once more (4 bytes, 0.16 ms).
// A handful of flops an element is far below the card's rate.
//
// Design: the wrapper hands every leaf in one table (pointers, element
// count, first chunk, dtype flags), passed by value as the kernel's
// parameter (a __grid_constant__ struct, up to MAX_LEAVES leaves, ~18 KB of
// the 32,764 bytes CUDA 12.1+ allows on sm_70 and later), so a launch costs
// no copy of the table and the grads, new tensors every step, need no device
// state.  Each leaf is cut into chunks of CHUNK elements, one block a chunk;
// a block finds its leaf by a binary search over the first chunks.  The
// first launch writes one float32 sum of squares a chunk; every block of the
// second reduces all those partials in one fixed order (so the norm, and
// every element's result, repeats from run to run), then updates its chunk
// with 16-byte loads of float32 (8-byte of bf16) four elements a thread-step
// where the leaf's pointers allow, element by element otherwise and for the
// tail.  A gradient that is the transpose of its parameter's last two dims
// (autograd's layout for a weight the forward reads transposed, as the MoE
// experts and router do) is read in place: its chunks are TILE x TILE
// squares, transposed through shared memory 32 x 32 at a time (the sum of
// squares reads its storage in order).  Block 0 writes the norm.  Asked for
// the update norms (the dynamics tap), the second launch also writes each
// chunk's sum of (new - old)^2 and a third folds them a leaf.

#include "common.cuh"

using namespace port;

namespace {

constexpr int NT = 256;              // threads per block
constexpr int CHUNK = 1 << 16;       // elements a block (kernels/adamw.py CHUNK)
constexpr int MAX_LEAVES = 320;      // leaves a launch (kernels/adamw.py MAX_LEAVES)
constexpr int TILE = 256;            // a transposed leaf's chunk: TILE x TILE (kernels/adamw.py)
constexpr int FIELDS = 9;            // int64 entries a leaf in the wrapper's table
constexpr int P_BF16 = 1, G_BF16 = 2, VEC = 4, G_VEC = 8, TRANS = 16;  // kernels/adamw.py flags

struct Table {
  void* p[MAX_LEAVES];
  const void* g[MAX_LEAVES];
  float* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  long long numel[MAX_LEAVES];
  int start[MAX_LEAVES + 1];  // first chunk of each leaf; start[n] = chunks
  int flags[MAX_LEAVES];
  int rows[MAX_LEAVES], cols[MAX_LEAVES];  // a TRANS leaf's last two dims
  int n;
};

struct Hyper {
  float b1, omb1, b2, omb2, bias1, bias2, eps, lr, decay, max_norm;
};

// The leaf whose chunks hold chunk c: the last i with start[i] <= c (an
// empty leaf shares its start with the next one and is never chosen).
__device__ __forceinline__ int leaf_of(const Table& t, int c) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.start[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Sum over the block, in one fixed order; every thread gets the result.
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[w] = x;
  __syncthreads();
  T s = 0;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) s += red[i];
  __syncthreads();
  return s;
}

// The sum of x[0..n), thread t taking t, t + NT, ... in double.
__device__ __forceinline__ double fixed_sum(const float* x, int n, double* red) {
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += NT) s += (double)x[i];
  return block_sum(s, red);
}

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
}

// x rounded to T and widened back (exact for float32).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// ---------------------------------------------------------------- sumsq

template <typename G>
__device__ __forceinline__ float chunk_sumsq(const G* g, int len, bool vec) {
  float s = 0.f;
  int i0 = 0;
  if (vec) {
    i0 = len & ~3;
    for (int i = threadIdx.x * 4; i < i0; i += NT * 4) {
      float x[4];
      load4(g + i, x);
#pragma unroll
      for (int k = 0; k < 4; ++k) s = __fadd_rn(s, __fmul_rn(x[k], x[k]));
    }
  }
  for (int i = i0 + threadIdx.x; i < len; i += NT) {
    const float x = to_f(g[i]);
    s = __fadd_rn(s, __fmul_rn(x, x));
  }
  return s;
}

__global__ void __launch_bounds__(NT)
sumsq_kernel(const __grid_constant__ Table t, float* __restrict__ partials) {
  __shared__ float red[NT / 32];
  const int c = blockIdx.x, i = leaf_of(t, c);
  const long long e0 = (long long)(c - t.start[i]) * CHUNK;
  const int len = (int)min((long long)CHUNK, t.numel[i] - e0);
  const int f = t.flags[i];
  const float s = (f & G_BF16)
                      ? chunk_sumsq((const __nv_bfloat16*)t.g[i] + e0, len, f & G_VEC)
                      : chunk_sumsq((const float*)t.g[i] + e0, len, f & G_VEC);
  const float total = block_sum(s, red);
  if (threadIdx.x == 0) partials[c] = total;
}

// --------------------------------------------------------------- update

struct Elem {
  float scale;
  Hyper h;
  // One element: returns the new parameter in float32 (already rounded to
  // P), updating m and v; `delta` gathers (new - old)^2.
  template <typename P, typename G>
  __device__ __forceinline__ float step(float p, float g, float& m, float& v) const {
    const float gs = round_to<G>(__fmul_rn(g, scale));
    m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(gs, h.omb1));
    v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(gs, gs), h.omb2));
    const float upd = __fdiv_rn(__fdiv_rn(m, h.bias1),
                                __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bias2)), h.eps));
    return round_to<P>(__fsub_rn(__fmul_rn(p, h.decay), __fmul_rn(h.lr, upd)));
  }
};

template <typename P, typename G>
__device__ __forceinline__ float chunk_update(const Elem& e, P* p, const G* g, float* m,
                                              float* v, int len, bool vec) {
  float d2 = 0.f;
  int i0 = 0;
  if (vec) {
    i0 = len & ~3;
    for (int i = threadIdx.x * 4; i < i0; i += NT * 4) {
      float pv[4], gv[4], mv[4], vv[4], nv[4];
      load4(p + i, pv);
      load4(g + i, gv);
      load4(m + i, mv);
      load4(v + i, vv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        nv[k] = e.step<P, G>(pv[k], gv[k], mv[k], vv[k]);
        const float d = __fsub_rn(nv[k], pv[k]);
        d2 = __fadd_rn(d2, __fmul_rn(d, d));
      }
      store4(p + i, nv);
      store4(m + i, mv);
      store4(v + i, vv);
    }
  }
  for (int i = i0 + threadIdx.x; i < len; i += NT) {
    const float old = to_f(p[i]);
    float mi = m[i], vi = v[i];
    const float nw = e.step<P, G>(old, to_f(g[i]), mi, vi);
    p[i] = from_f<P>(nw);
    m[i] = mi;
    v[i] = vi;
    const float d = __fsub_rn(nw, old);
    d2 = __fadd_rn(d2, __fmul_rn(d, d));
  }
  return d2;
}

// A TRANS leaf: p, m and v hold a (rows, cols) matrix row-major, g its
// transpose (the layout autograd hands back for a weight read as w^T).  The
// block updates the TILE x TILE square at (r0, c0) in strips of 32 rows x
// TW columns: the strip's g (TW rows of 32) is read along its rows into
// shared memory, then p, m and v along theirs, so every warp reads and
// writes 128 contiguous bytes; each thread issues all its loads of a phase
// before it uses any (TW / 4 of g, then 3 TW / 4 of p, m and v).
constexpr int TW = 64;

template <typename P, typename G>
__device__ __forceinline__ float chunk_update_t(const Elem& e, P* __restrict__ p,
                                                const G* __restrict__ g, float* __restrict__ m,
                                                float* __restrict__ v, int R, int C, int r0,
                                                int c0, float (*tile)[33]) {
  constexpr int WARPS = NT / 32, GU = TW / WARPS, PU = 32 / WARPS, PH = TW / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r1 = min(r0 + TILE, R), c1 = min(c0 + TILE, C);
  float d2 = 0.f;
  for (int tr = r0; tr < r1; tr += 32) {
    for (int tc = c0; tc < c1; tc += TW) {
      float gv[GU];
#pragma unroll
      for (int u = 0; u < GU; ++u) {
        const int col = tc + w + u * WARPS, row = tr + lane;
        gv[u] = (col < C && row < R) ? to_f(g[(long long)col * R + row]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < GU; ++u) tile[w + u * WARPS][lane] = gv[u];
      __syncthreads();
      float pv[PU][PH], mv[PU][PH], vv[PU][PH];
#pragma unroll
      for (int u = 0; u < PU; ++u) {
#pragma unroll
        for (int h = 0; h < PH; ++h) {
          const int row = tr + w + u * WARPS, col = tc + lane + 32 * h;
          if (row < R && col < C) {
            const long long k = (long long)row * C + col;
            pv[u][h] = to_f(p[k]);
            mv[u][h] = m[k];
            vv[u][h] = v[k];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < PU; ++u) {
#pragma unroll
        for (int h = 0; h < PH; ++h) {
          const int row = tr + w + u * WARPS, col = tc + lane + 32 * h;
          if (row < R && col < C) {
            const long long k = (long long)row * C + col;
            const float old = pv[u][h];
            const float nw = e.step<P, G>(old, tile[lane + 32 * h][w + u * WARPS], mv[u][h],
                                          vv[u][h]);
            p[k] = from_f<P>(nw);
            m[k] = mv[u][h];
            v[k] = vv[u][h];
            const float d = __fsub_rn(nw, old);
            d2 = __fadd_rn(d2, __fmul_rn(d, d));
          }
        }
      }
      __syncthreads();
    }
  }
  return d2;
}

// norm_partials (n_norm of them, the whole step's) give the clip's scale;
// null means no clip (scale 1).  grad_norm, when not null, gets the norm
// (block 0).  delta, when not null, gets each chunk's sum of (new - old)^2.
__global__ void __launch_bounds__(NT)
update_kernel(const __grid_constant__ Table t, const Hyper h,
              const float* __restrict__ norm_partials, int n_norm, float* __restrict__ grad_norm,
              float* __restrict__ delta) {
  __shared__ double dred[NT / 32];
  __shared__ float fred[NT / 32];
  __shared__ float tile[TW][33];
  Elem e{1.f, h};
  if (norm_partials != nullptr) {
    const float norm = __fsqrt_rn((float)fixed_sum(norm_partials, n_norm, dred));
    const float q = __fdiv_rn(h.max_norm, __fadd_rn(norm, 1e-6f));
    e.scale = q > 1.f ? 1.f : q;  // a NaN norm keeps a NaN scale, as torch.clamp does
    if (grad_norm != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *grad_norm = norm;
  }
  const int c = blockIdx.x, i = leaf_of(t, c);
  const int f = t.flags[i];
  float d2;
  if (f & TRANS) {
    // Chunk (b, square row, square column) of the leaf's matrices.
    const int R = t.rows[i], C = t.cols[i];
    const int rb = (R + TILE - 1) / TILE, cb = (C + TILE - 1) / TILE;
    const int local = c - t.start[i], b = local / (rb * cb), sq = local % (rb * cb);
    const long long e0 = (long long)b * R * C;
    const int r0 = (sq / cb) * TILE, c0 = (sq % cb) * TILE;
    float* m = t.m[i] + e0;
    float* v = t.v[i] + e0;
    if (f & P_BF16) {
      __nv_bfloat16* p = (__nv_bfloat16*)t.p[i] + e0;
      d2 = (f & G_BF16)
               ? chunk_update_t(e, p, (const __nv_bfloat16*)t.g[i] + e0, m, v, R, C, r0, c0, tile)
               : chunk_update_t(e, p, (const float*)t.g[i] + e0, m, v, R, C, r0, c0, tile);
    } else {
      float* p = (float*)t.p[i] + e0;
      d2 = (f & G_BF16)
               ? chunk_update_t(e, p, (const __nv_bfloat16*)t.g[i] + e0, m, v, R, C, r0, c0, tile)
               : chunk_update_t(e, p, (const float*)t.g[i] + e0, m, v, R, C, r0, c0, tile);
    }
  } else {
    const long long e0 = (long long)(c - t.start[i]) * CHUNK;
    const int len = (int)min((long long)CHUNK, t.numel[i] - e0);
    const bool vec = f & VEC;
    float* m = t.m[i] + e0;
    float* v = t.v[i] + e0;
    if (f & P_BF16) {
      __nv_bfloat16* p = (__nv_bfloat16*)t.p[i] + e0;
      d2 = (f & G_BF16) ? chunk_update(e, p, (const __nv_bfloat16*)t.g[i] + e0, m, v, len, vec)
                        : chunk_update(e, p, (const float*)t.g[i] + e0, m, v, len, vec);
    } else {
      float* p = (float*)t.p[i] + e0;
      d2 = (f & G_BF16) ? chunk_update(e, p, (const __nv_bfloat16*)t.g[i] + e0, m, v, len, vec)
                        : chunk_update(e, p, (const float*)t.g[i] + e0, m, v, len, vec);
    }
  }
  if (delta != nullptr) {
    const float total = block_sum(d2, fred);
    if (threadIdx.x == 0) delta[c] = total;
  }
}

// ----------------------------------------------------------------- folds

// Block i: out[i] = sqrt of the sum of x over leaf i's chunks.
__global__ void __launch_bounds__(NT)
fold_kernel(const __grid_constant__ Table t, const float* __restrict__ x,
            float* __restrict__ out) {
  __shared__ double red[NT / 32];
  const int i = blockIdx.x, a = t.start[i];
  const double s = fixed_sum(x + a, t.start[i + 1] - a, red);
  if (threadIdx.x == 0) out[i] = __fsqrt_rn((float)s);
}

// out[0] = sqrt of the sum of x[0..n), in update_kernel's order.
__global__ void __launch_bounds__(NT) norm_kernel(const float* __restrict__ x, int n, float* out) {
  __shared__ double red[NT / 32];
  const double s = fixed_sum(x, n, red);
  if (threadIdx.x == 0) *out = __fsqrt_rn((float)s);
}

// The table from the wrapper's flat int64 entries: per leaf p, g, m, v,
// numel, first chunk, flags, rows, cols.
bool fill(Table& t, const long long* flat, int n_leaves, int n_chunks) {
  if (n_leaves <= 0 || n_leaves > MAX_LEAVES || n_chunks < 0) return false;
  t.n = n_leaves;
  for (int i = 0; i < n_leaves; ++i) {
    const long long* e = flat + (long long)i * FIELDS;
    t.p[i] = (void*)e[0];
    t.g[i] = (const void*)e[1];
    t.m[i] = (float*)e[2];
    t.v[i] = (float*)e[3];
    t.numel[i] = e[4];
    t.start[i] = (int)e[5];
    t.flags[i] = (int)e[6];
    t.rows[i] = (int)e[7];
    t.cols[i] = (int)e[8];
  }
  t.start[n_leaves] = n_chunks;
  return true;
}

}  // namespace

// The sum of squares of every chunk of the table's gradients into
// partials[0..n_chunks).
extern "C" int adamw_sumsq_launch(const long long* table, int n_leaves, int n_chunks,
                                  float* partials, void* stream) {
  Table t;
  if (!fill(t, table, n_leaves, n_chunks)) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  sumsq_kernel<<<n_chunks, NT, 0, (cudaStream_t)stream>>>(t, partials);
  return (int)cudaGetLastError();
}

// The clip (norm_partials not null: the whole step's n_norm partials) and
// the update of every chunk of the table.  hyper: b1, 1 - b1, b2, 1 - b2,
// bias1, bias2, eps, lr, 1 - lr wd, max_norm.
extern "C" int adamw_update_launch(const long long* table, int n_leaves, int n_chunks,
                                   const float* hyper, const float* norm_partials, int n_norm,
                                   float* grad_norm, float* delta, void* stream) {
  Table t;
  if (!fill(t, table, n_leaves, n_chunks) || n_norm < 0) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  const Hyper h{hyper[0], hyper[1], hyper[2], hyper[3], hyper[4],
                hyper[5], hyper[6], hyper[7], hyper[8], hyper[9]};
  update_kernel<<<n_chunks, NT, 0, (cudaStream_t)stream>>>(t, h, norm_partials, n_norm,
                                                           grad_norm, delta);
  return (int)cudaGetLastError();
}

// out[i] = sqrt(sum of x over leaf i's chunks), for the table's leaves.
extern "C" int adamw_fold_launch(const long long* table, int n_leaves, int n_chunks,
                                 const float* x, float* out, void* stream) {
  Table t;
  if (!fill(t, table, n_leaves, n_chunks)) return (int)cudaErrorInvalidValue;
  fold_kernel<<<n_leaves, NT, 0, (cudaStream_t)stream>>>(t, x, out);
  return (int)cudaGetLastError();
}

// out[0] = sqrt(sum of x[0..n)).
extern "C" int adamw_norm_launch(const float* x, int n, float* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  norm_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(x, n, out);
  return (int)cudaGetLastError();
}
