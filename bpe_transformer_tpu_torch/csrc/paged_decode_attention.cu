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
//   int32 or int64 -> out (S, H, d) in q's type.  The pool holds q's type,
//   or int8 with one float32 scale per (block, kv head) in k_scale / v_scale
//   (NB, KV).  Any head dim d and any group H / KV, with the geometry of
//   decode_attention.cu (padded widths W, register widths D = min(W, 256)
//   with W / D output-column chunks on gridDim.y, head chunks G).
//
// Bound on the H100: bytes.  Each live key row (keys 0..pos of the slot) is
// read once, with its block's two scales for an int8 pool, and used for
// 4 * G * d flops: far below the ~295 flops per byte where the card turns
// compute-bound.  The floor is the live K/V bytes over 3.35 TB/s; at a
// decode tick that is a few MB, so the time goes to getting them in flight
// on every SM at once.
//
// Design: the dense kernel's split-KV machinery (decode_common.cuh) with the
// block table in the copies.  Block (slot, kv head, head chunk, split) owns
// one span of `span` keys of its slot (the wrapper's decode_splits) and
// reads it once for the G query heads of its chunk; a span past the frontier
// exits before any load.  The pool's rows of one (pool block, kv head) are
// one contiguous run of bs * d elements, so a tile of tk keys is handed over
// as one bulk copy per pool block it touches (a sub-run where the block is
// longer than the tile), all on the tile's mbarrier: the lanes of warp 0
// read the tile's table entries and issue the copies together, before the
// block reads q.  Only entries up to pos / bs are read (past them lie the
// trash block 0 or stale entries), and only by the block that copies those
// keys.  Rows a bulk copy cannot address (not whole 16-byte units, or an
// unaligned pool) are read by every thread's direct loads into the same
// tiles.  The span's scores stay in shared memory, so its softmax is one
// pass; for an int8 pool each key's score is multiplied by its pool block's
// K scale before the softmax and its probability by the V scale after it,
// while the denominator sums the unscaled weights (dequantization is
// linear, so this equals attending over k * scale and v * scale).  The spans
// of one (slot, kv head, chunk) merge in the same launch, in split order, in
// the block that arrives last.  One launch a call, no atomics on sums (two
// calls give the same bits), no allocation: the wrapper hands in the split
// workspace and the counters.  The kernel is templated on q's type and on
// the pool's storage type (q's type or int8).

#include <type_traits>

#include "decode_common.cuh"

using namespace port;

namespace {

struct Params {
  const void *q, *k, *v, *pos;
  const int* tables;
  const float *k_scale, *v_scale;
  void* out;
  float* ws;
  int* counters;
  int H, KV, bs, nbs, dt, W, group, n_chunks, n_splits, span, pos64;
  int tk, stages;     // keys a tile, tiles a ring
  size_t tile_bytes;  // bytes a tile takes in shared memory (128-byte aligned)
  float qscale;
  bool bulk;
};

__host__ __device__ inline size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// The pool blocks of one span (at most MAX_SPAN keys: MAX_SPAN + 1 blocks
// when bs does not divide the span's start) and an int8 pool's scales.
struct SpanBlocks {
  int tab[decode::MAX_SPAN + 1];
  float ks[decode::MAX_SPAN + 1], vs[decode::MAX_SPAN + 1];
};

// Key j of the span (key0 + j of the slot) lies in span block
// (key0 + j) / bs - pb0.
struct BlockScales {
  static constexpr bool on = true;
  const SpanBlocks* sb;
  int key0, bs, pb0;
  __device__ float k(int j) const { return sb->ks[(key0 + j) / bs - pb0]; }
  __device__ float v(int j) const { return sb->vs[(key0 + j) / bs - pb0]; }
};

template <typename TQ, typename TKV, int D, int G>
__global__ void __launch_bounds__(decode::THREADS) paged_decode_kernel(const Params p) {
  using namespace decode;
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  extern __shared__ __align__(128) unsigned char dyn[];  // K ring, V ring, then q
  __shared__ Shared<G> sh;
  __shared__ SpanBlocks sb;
  __shared__ __align__(8) uint64_t bars[2][MAX_STAGES];  // [K, V][stage]

  const int group_idx = blockIdx.x / p.n_splits * gridDim.y + blockIdx.y;
  const int split = blockIdx.x % p.n_splits;
  const int chunk = blockIdx.x / p.n_splits % p.n_chunks;
  const int kvh = blockIdx.x / (p.n_splits * p.n_chunks) % p.KV;
  const int s = blockIdx.x / (p.n_splits * p.n_chunks * p.KV);
  const int head0 = kvh * p.group + chunk * G;             // first query head of the chunk
  const int ng = min(G, kvh * p.group + p.group - head0);  // its live heads
  const int dt = p.dt, tk = p.tk, nst = p.stages, bs = p.bs, z0 = blockIdx.y * D;
  const int ctx = p.nbs * bs;
  TQ* ob = static_cast<TQ*>(p.out) + ((size_t)s * p.H + head0) * dt;
  const long long ps = p.pos64 ? static_cast<const long long*>(p.pos)[s]
                               : static_cast<const int*>(p.pos)[s];
  const int n_keys = (int)(ps < ctx - 1 ? ps : ctx - 1) + 1;
  if (n_keys <= 0) {  // nothing visible: zeros, as an empty softmax's weighted sum
    if (split == 0)
      for (int i = threadIdx.x; i < G * D; i += THREADS)
        if (i / D < ng && z0 + i % D < dt) ob[i / D * dt + z0 + i % D] = from_f<TQ>(0.f);
    return;
  }
  const int key0 = split * p.span;
  if (key0 >= n_keys) return;  // a span past the frontier: no load at all
  const int key1 = min(key0 + p.span, n_keys);
  const int n_live = (n_keys + p.span - 1) / p.span;
  const int n_tiles = (key1 - key0 + tk - 1) / tk;
  const int pb0 = key0 / bs, n_pb = (key1 - 1) / bs - pb0 + 1;
  const int* tab = p.tables + (size_t)s * p.nbs;  // live entries: 0 .. (n_keys - 1) / bs

  const size_t row_elems = (size_t)bs * dt;  // one (pool block, kv head) run
  const TKV* kp = static_cast<const TKV*>(p.k);
  const TKV* vp = static_cast<const TKV*>(p.v);
  auto ktile = [&](int st) { return reinterpret_cast<TKV*>(dyn + st * p.tile_bytes); };
  auto vtile = [&](int st) { return reinterpret_cast<TKV*>(dyn + (nst + st) * p.tile_bytes); };
  float* q_sh = reinterpret_cast<float*>(dyn + 2 * nst * p.tile_bytes);
  // Tile i of K (kv 0) or V (kv 1): keys key0 + i tk .. (at most tk, none
  // past the frontier) into stage i % nst, one bulk copy per pool block it
  // touches; run by the 32 lanes of warp 0 together.
  auto issue = [&](int kv, int i) {
    const int st = i % nst, start = key0 + i * tk, rows = min(tk, key1 - start);
    if (threadIdx.x == 0)
      sm90::mbar_expect_tx(&bars[kv][st], (uint32_t)(rows * dt * sizeof(TKV)));
    __syncwarp();
    const int first = start / bs, last = (start + rows - 1) / bs;
    for (int pb = first + (int)threadIdx.x; pb <= last; pb += 32) {
      const int a = max(start, pb * bs), b = min(start + rows, (pb + 1) * bs);
      const TKV* src = (kv ? vp : kp) + ((size_t)tab[pb] * p.KV + kvh) * row_elems +
                       (size_t)(a - pb * bs) * dt;
      sm90::bulk_load((kv ? vtile(st) : ktile(st)) + (size_t)(a - start) * dt, src,
                      (uint32_t)((b - a) * dt * sizeof(TKV)), &bars[kv][st]);
    }
  };
  if (p.bulk && threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < nst; ++st) {
        sm90::mbar_init(&bars[0][st], 1);
        sm90::mbar_init(&bars[1][st], 1);
      }
      sm90::fence_barrier_init();
    }
    __syncwarp();
    for (int kv = 0; kv < 2; ++kv)
      for (int i = 0; i < min(nst, n_tiles); ++i) issue(kv, i);
  }
  for (int j = threadIdx.x; j < n_pb; j += THREADS) {
    const int blk = tab[pb0 + j];
    sb.tab[j] = blk;
    if constexpr (QUANT) {
      sb.ks[j] = p.k_scale[(size_t)blk * p.KV + kvh];
      sb.vs[j] = p.v_scale[(size_t)blk * p.KV + kvh];
    }
  }
  load_q(static_cast<const TQ*>(p.q) + ((size_t)s * p.H + head0) * dt, G, dt, ng, p.qscale, q_sh);

  // Tile i of K or V is ready in stage i % nst: wait for its copy, or load
  // it here (row by row through the span's table entries).
  auto ready = [&](int kv, int i) {
    const int st = i % nst, start = key0 + i * tk, rows = min(tk, key1 - start);
    if (p.bulk) {
      sm90::mbar_wait(&bars[kv][st], (i / nst) & 1);
    } else {
      const TKV* base = kv ? vp : kp;
      TKV* dst = kv ? vtile(st) : ktile(st);
      __syncthreads();
      for (int e = threadIdx.x; e < rows * dt; e += THREADS) {
        const int key = start + e / dt;
        dst[e] = base[((size_t)sb.tab[key / bs - pb0] * p.KV + kvh) * row_elems +
                      (size_t)(key % bs) * dt + e % dt];
      }
      __syncthreads();
    }
  };
  // Stage i % nst is free again: refill it with tile i + nst.
  auto refill = [&](int kv, int i) {
    if (p.bulk && i + nst < n_tiles) {
      __syncthreads();
      if (threadIdx.x < 32) {
        sm90::fence_proxy_async();
        issue(kv, i + nst);
      }
    }
  };

  const bool whole = dt == D && p.W == D;
  for (int i = 0; i < n_tiles; ++i) {
    const int rows = min(tk, key1 - key0 - i * tk);
    ready(0, i);
    if (whole) {
      score_whole<TKV, D, G>(ktile(i % nst), rows, i * tk, q_sh, sh);
    } else {
      score_general<TKV, G>(ktile(i % nst), rows, i * tk, dt, q_sh, sh);
    }
    refill(0, i);
  }
  __syncthreads();
  if constexpr (QUANT) {
    softmax_span<G>(key1 - key0, sh, BlockScales{&sb, key0, bs, pb0});
  } else {
    softmax_span<G>(key1 - key0, sh);
  }
  __syncthreads();
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    ready(1, i);
    value_tile<TKV, D, G>(vtile(i % nst), min(tk, key1 - key0 - i * tk), i * tk, dt, z0, whole,
                          sh, acc);
    refill(1, i);
  }
  finish_split<TQ, D, G>(acc, sh, split, n_live,
                         p.ws + (size_t)group_idx * p.n_splits * slot_floats<G, D>(),
                         p.counters + group_idx, ob, dt, z0, ng);
}

template <typename TQ, typename TKV, int D, int G>
cudaError_t launch_g(const Params& a, int S, cudaStream_t stream) {
  static int allowed[64] = {0};  // dynamic shared memory allowed so far, per device
  const dim3 grid(S * a.KV * a.n_chunks * a.n_splits, a.W / D), block(decode::THREADS);
  const size_t smem = 2 * a.stages * a.tile_bytes + ((size_t)G * a.dt * sizeof(float) + 15) / 16 * 16;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidValue;
  const size_t static_smem = sizeof(decode::Shared<G>) + sizeof(SpanBlocks) + 256;
  if (smem + static_smem > 48 * 1024 && (int)smem > allowed[dev]) {
    err = cudaFuncSetAttribute(paged_decode_kernel<TQ, TKV, D, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = (int)smem;
  }
  paged_decode_kernel<TQ, TKV, D, G><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_d(int G, const Params& a, int S, cudaStream_t stream) {
  switch (G) {
    case 1: return launch_g<TQ, TKV, D, 1>(a, S, stream);
    case 2: return launch_g<TQ, TKV, D, 2>(a, S, stream);
    case 4: return launch_g<TQ, TKV, D, 4>(a, S, stream);
    case 8:
      if constexpr (D <= 128) return launch_g<TQ, TKV, D, 8>(a, S, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
cudaError_t launch_t(int D, int G, Params a, int S, cudaStream_t stream) {
  const int row_bytes = a.dt * (int)sizeof(TKV);
  a.tk = decode::tile_keys(row_bytes);
  a.tile_bytes = align128((size_t)a.tk * row_bytes);
  a.stages = decode::ring_stages(a.span, a.tk, a.tile_bytes);
  a.bulk = row_bytes % 16 == 0 && (uintptr_t)a.k % 16 == 0 && (uintptr_t)a.v % 16 == 0;
  switch (D) {
    case 16: return launch_d<TQ, TKV, 16>(G, a, S, stream);
    case 32: return launch_d<TQ, TKV, 32>(G, a, S, stream);
    case 64: return launch_d<TQ, TKV, 64>(G, a, S, stream);
    case 128: return launch_d<TQ, TKV, 128>(G, a, S, stream);
    case 256: return launch_d<TQ, TKV, 256>(G, a, S, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (S, H, d) and out in q's type (dtype code), k/v pools (NB, KV, bs, d) in
// q's type or int8 (kv_dtype code), tables (S, nbs) int32, pos (S,) int32
// (pos_dtype 0) or int64 (1), k_scale / v_scale (NB, KV) float32 for int8
// pools (else NULL); all contiguous.  W in {16, 32, 64, 128, 256} or a
// multiple of 256 is the padded width of the true head dim d <= W (the
// register width is min(W, 256)); the group H / KV runs in n_chunks chunks
// of G in {1, 2, 4, 8} heads (G <= 4 from W = 256), G * n_chunks >= H / KV.
// A slot's nbs * bs keys run in n_splits spans of `span` keys (at most
// decode::MAX_SPAN, n_splits * span >= nbs * bs), moved in tiles of at most
// decode::TILE_BYTES of K (and of V).  ws holds S * KV * n_chunks * (W / D)
// * n_splits slots of G * (D + 2) floats; counters one int a (slot, kv head,
// chunk, column chunk), zero on entry and left zero.
extern "C" int paged_decode_attention_launch(int dtype, const void* q, const void* k,
                                             const void* v, const void* tables, const void* pos,
                                             const void* k_scale, const void* v_scale, void* out,
                                             void* ws, void* counters, int kv_dtype,
                                             int pos_dtype, int S, int H, int KV, int bs, int nbs,
                                             int W, int d, int G, int n_chunks, int n_splits,
                                             int span, void* stream) {
  if (S <= 0 || KV <= 0 || H % KV || bs <= 0 || nbs <= 0 || (long long)nbs * bs > 0x7fffffff ||
      d <= 0 || d > W || n_chunks <= 0 || G * n_chunks < H / KV || n_splits <= 0 || span <= 0 ||
      span > decode::MAX_SPAN || (long long)n_splits * span < (long long)nbs * bs ||
      (pos_dtype != 0 && pos_dtype != 1) ||
      (long long)S * KV * n_chunks * n_splits > 0x7fffffff || (W > 256 && W % 256) ||
      W / 256 > 65535)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == I8 && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  Params a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.pos = pos;
  a.tables = (const int*)tables;
  a.k_scale = (const float*)k_scale;
  a.v_scale = (const float*)v_scale;
  a.out = out;
  a.ws = (float*)ws;
  a.counters = (int*)counters;
  a.H = H;
  a.KV = KV;
  a.bs = bs;
  a.nbs = nbs;
  a.dt = d;
  a.W = W;
  a.group = H / KV;
  a.n_chunks = n_chunks;
  a.n_splits = n_splits;
  a.span = span;
  a.pos64 = pos_dtype;
  a.qscale = decode::LOG2E / sqrtf((float)d);
  const int D = W > 256 ? 256 : W;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32 && kv_dtype == F32) return (int)launch_t<float, float>(D, G, a, S, s);
  if (dtype == F32 && kv_dtype == I8) return (int)launch_t<float, int8_t>(D, G, a, S, s);
  if (dtype == BF16 && kv_dtype == BF16)
    return (int)launch_t<__nv_bfloat16, __nv_bfloat16>(D, G, a, S, s);
  if (dtype == BF16 && kv_dtype == I8) return (int)launch_t<__nv_bfloat16, int8_t>(D, G, a, S, s);
  return (int)cudaErrorInvalidValue;
}
