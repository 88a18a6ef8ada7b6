// Decode-step (single-query) attention against a dense KV cache.
//
// Replaces: bpe_transformer_tpu/kernels/pallas/decode_attention.py
//   decode_attention (line 107; kernel _decode_kernel at 57, pallas_call at 213).
// Computes: out[b, h] = softmax(q[b, h] . k[b, kv, 0..pos[b]] / sqrt(d)) v[...]
//   with kv = h / (H / KV): GQA groups are consecutive query heads.
//   q (B, H, d), k/v cache (B, KV, ctx, d), pos (B,) int -> out (B, H, d),
//   for any head dim d and any group H / KV (the JAX kernel pads d to 128
//   lanes and the group to 8 sublanes).
//
// Bound on the H100: bytes.  Each live cache row (keys 0..pos) is read once
// and used for 4 * G * d flops, far below the ~295 flops per byte where the
// card turns compute-bound; the floor is the live K/V bytes over 3.35 TB/s.
// At a decode tick those bytes are a few MB, so the time goes to getting
// them in flight on every SM at once.
//
// Design against that bound (split-KV, "flash-decoding"): the TPU kernel's
// sequential key grid becomes a grid axis of splits.  Block (b, kv head,
// head chunk, split) owns one contiguous span of `span` keys of its slot (at
// most 256; the wrapper's decode_splits picks it from ctx) and reads it
// exactly once for all G query heads of its chunk; a block whose span starts
// past pos[b] exits before any load, and no row past pos is read, so a
// ragged ctx needs no padding.  Thread 0 issues the whole span's K tiles and
// then its V tiles at once (a ring of up to 8 tiles of up to 64 keys each,
// reused only where a span outgrows it), each one bulk copy of contiguous
// bytes (the keys of one slot and kv head are one run) on its own mbarrier,
// before the block even reads q; the scores of a tile start as soon as it
// lands, while the rest are in flight.  Rows that a bulk copy cannot address
// (rows that are not whole 16-byte units, such as bf16 d 17, or an unaligned
// base) are read by direct loads of every thread instead.  The span's
// scores stay in shared memory, so its softmax is one pass; the spans of one
// (b, kv head, chunk) merge in the same launch, in split order, in the block
// that arrives last (decode_common.cuh).  The CUDA cores suffice: at G <= 8
// heads a key row is worth a few flops a byte.  pos may be int32 or int64
// (the engines' own position vectors), so a call is one launch.
//
// Geometry: the kernel is instantiated for register widths D in {16, 32, 64,
// 128, 256} and head chunks G in {1, 2, 4, 8} (at most 4 at D = 256).  The
// common case (the head dim is its register width, one column chunk) reads
// rows as 16-byte chunks at compile-time offsets; any other head dim d reads
// rows of d elements one element at a time.  Above 256, W (a multiple of
// 256) runs in W / 256 output-column chunks on gridDim.y: every chunk's
// block scores the full row and accumulates its own 256 columns (off the
// main path: no preset has a head dim above 128).  A group of g query heads
// is cut into ceil(g / G) chunks of G heads (the last one masks the heads
// past g); the wrapper picks the smallest G that holds the group, so a group
// of 3 runs one chunk of 4 and a group of 12 two chunks of 8, and every chunk
// reads its kv head's rows.

#include "decode_common.cuh"

using namespace port;

namespace {

struct Params {
  const void *q, *k, *v, *pos;
  void* out;
  float* ws;
  int* counters;
  int H, KV, ctx, dt, W, group, n_chunks, n_splits, span, pos64;
  int tk, stages;    // keys a tile, tiles a ring
  size_t tile_bytes; // bytes a tile takes in shared memory (128-byte aligned)
  float qscale;
  bool bulk;
};

__host__ __device__ inline size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

template <typename T, int D, int G>
__global__ void __launch_bounds__(decode::THREADS) decode_attention_kernel(const Params p) {
  using namespace decode;
  extern __shared__ __align__(128) unsigned char dyn[];  // K ring, V ring, then q
  __shared__ Shared<G> sh;
  __shared__ __align__(8) uint64_t bars[2][MAX_STAGES];  // [K, V][stage]

  const int group_idx = blockIdx.x / p.n_splits * gridDim.y + blockIdx.y;
  const int split = blockIdx.x % p.n_splits;
  const int chunk = blockIdx.x / p.n_splits % p.n_chunks;
  const int kvh = blockIdx.x / (p.n_splits * p.n_chunks) % p.KV;
  const int b = blockIdx.x / (p.n_splits * p.n_chunks * p.KV);
  const int head0 = kvh * p.group + chunk * G;           // first query head of the chunk
  const int ng = min(G, kvh * p.group + p.group - head0);  // its live heads
  const int dt = p.dt, tk = p.tk, nst = p.stages, z0 = blockIdx.y * D;
  T* ob = static_cast<T*>(p.out) + ((size_t)b * p.H + head0) * dt;
  const long long pb = p.pos64 ? static_cast<const long long*>(p.pos)[b]
                               : static_cast<const int*>(p.pos)[b];
  const int n_keys = (int)(pb < p.ctx - 1 ? pb : p.ctx - 1) + 1;
  if (n_keys <= 0) {  // nothing visible: zeros, as an empty softmax's weighted sum
    if (split == 0)
      for (int i = threadIdx.x; i < G * D; i += THREADS)
        if (i / D < ng && z0 + i % D < dt) ob[i / D * dt + z0 + i % D] = from_f<T>(0.f);
    return;
  }
  const int key0 = split * p.span;
  if (key0 >= n_keys) return;  // a span past the frontier: no load at all
  const int key1 = min(key0 + p.span, n_keys);
  const int n_live = (n_keys + p.span - 1) / p.span;
  const int n_tiles = (key1 - key0 + tk - 1) / tk;

  const size_t head_off = ((size_t)b * p.KV + kvh) * p.ctx * dt;
  const T* kb = static_cast<const T*>(p.k) + head_off;
  const T* vb = static_cast<const T*>(p.v) + head_off;
  auto ktile = [&](int s) { return reinterpret_cast<T*>(dyn + s * p.tile_bytes); };
  auto vtile = [&](int s) { return reinterpret_cast<T*>(dyn + (nst + s) * p.tile_bytes); };
  float* q_sh = reinterpret_cast<float*>(dyn + 2 * nst * p.tile_bytes);
  // Tile i of K (kv 0) or V (kv 1): keys key0 + i tk .. (at most tk, none
  // past the frontier) into stage i % nst.
  auto issue = [&](int kv, int i) {
    const int s = i % nst, start = key0 + i * tk;
    const uint32_t bytes = (uint32_t)(min(tk, key1 - start) * dt * sizeof(T));
    sm90::mbar_expect_tx(&bars[kv][s], bytes);
    sm90::bulk_load(kv ? vtile(s) : ktile(s), (kv ? vb : kb) + (size_t)start * dt, bytes,
                    &bars[kv][s]);
  };
  if (p.bulk && threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      sm90::mbar_init(&bars[0][s], 1);
      sm90::mbar_init(&bars[1][s], 1);
    }
    sm90::fence_barrier_init();
    for (int kv = 0; kv < 2; ++kv)
      for (int i = 0; i < min(nst, n_tiles); ++i) issue(kv, i);
  }
  load_q(static_cast<const T*>(p.q) + ((size_t)b * p.H + head0) * dt, G, dt, ng, p.qscale, q_sh);

  // Tile i of K or V is ready in stage i % nst: wait for its copy, or load
  // it here.
  auto ready = [&](int kv, int i) {
    const int s = i % nst, start = key0 + i * tk;
    if (p.bulk) {
      sm90::mbar_wait(&bars[kv][s], (i / nst) & 1);
    } else {
      const T* src = (kv ? vb : kb) + (size_t)start * dt;
      T* dst = kv ? vtile(s) : ktile(s);
      __syncthreads();
      for (int e = threadIdx.x; e < min(tk, key1 - start) * dt; e += THREADS) dst[e] = src[e];
      __syncthreads();
    }
  };
  // Stage i % nst is free again: refill it with tile i + nst.
  auto refill = [&](int kv, int i) {
    if (p.bulk && i + nst < n_tiles) {
      __syncthreads();
      if (threadIdx.x == 0) {
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
      score_whole<T, D, G>(ktile(i % nst), rows, i * tk, q_sh, sh);
    } else {
      score_general<T, G>(ktile(i % nst), rows, i * tk, dt, q_sh, sh);
    }
    refill(0, i);
  }
  __syncthreads();
  softmax_span<G>(key1 - key0, sh);
  __syncthreads();
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    ready(1, i);
    value_tile<T, D, G>(vtile(i % nst), min(tk, key1 - key0 - i * tk), i * tk, dt, z0, whole,
                        sh, acc);
    refill(1, i);
  }
  finish_split<T, D, G>(acc, sh, split, n_live,
                        p.ws + (size_t)group_idx * p.n_splits * slot_floats<G, D>(),
                        p.counters + group_idx, ob, dt, z0, ng);
}

template <typename T, int D, int G>
cudaError_t launch_g(const Params& a, int B, cudaStream_t stream) {
  static int allowed[64] = {0};  // dynamic shared memory allowed so far, per device
  const dim3 grid(B * a.KV * a.n_chunks * a.n_splits, a.W / D), block(decode::THREADS);
  const size_t smem = 2 * a.stages * a.tile_bytes + ((size_t)G * a.dt * sizeof(float) + 15) / 16 * 16;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidValue;
  if (smem > 48 * 1024 - sizeof(decode::Shared<G>) - 256 && (int)smem > allowed[dev]) {
    err = cudaFuncSetAttribute(decode_attention_kernel<T, D, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = (int)smem;
  }
  decode_attention_kernel<T, D, G><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(int G, const Params& a, int B, cudaStream_t stream) {
  switch (G) {
    case 1: return launch_g<T, D, 1>(a, B, stream);
    case 2: return launch_g<T, D, 2>(a, B, stream);
    case 4: return launch_g<T, D, 4>(a, B, stream);
    case 8:
      if constexpr (D <= 128) return launch_g<T, D, 8>(a, B, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(int D, int G, Params a, int B, cudaStream_t stream) {
  const int row_bytes = a.dt * (int)sizeof(T);
  a.tk = decode::tile_keys(row_bytes);
  a.tile_bytes = align128((size_t)a.tk * row_bytes);
  a.stages = decode::ring_stages(a.span, a.tk, a.tile_bytes);
  a.bulk = row_bytes % 16 == 0 && (uintptr_t)a.k % 16 == 0 && (uintptr_t)a.v % 16 == 0;
  switch (D) {
    case 16: return launch_d<T, 16>(G, a, B, stream);
    case 32: return launch_d<T, 32>(G, a, B, stream);
    case 64: return launch_d<T, 64>(G, a, B, stream);
    case 128: return launch_d<T, 128>(G, a, B, stream);
    case 256: return launch_d<T, 256>(G, a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, d), k/v (B, KV, ctx, d), pos (B,) int32 (pos_dtype 0) or int64
// (1), out (B, H, d); all contiguous.  W in {16, 32, 64, 128, 256} or a
// multiple of 256 is the padded width of the true head dim d <= W (the
// register width is min(W, 256)); the group H / KV runs in n_chunks chunks
// of G in {1, 2, 4, 8} heads (G <= 4 from W = 256), G * n_chunks >= H / KV.
// The keys run in n_splits spans of `span` keys (at most 256, n_splits *
// span >= ctx), moved in tiles of at most decode::TILE_BYTES of K (and of
// V).  ws holds B * KV * n_chunks * (W / D) * n_splits slots of G * (D + 2)
// floats; counters one int a (b, kv head, chunk, column chunk), zero on
// entry and left zero.
extern "C" int decode_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                       const void* pos, void* out, void* ws, void* counters,
                                       int pos_dtype, int B, int H, int KV, int ctx, int W, int d,
                                       int G, int n_chunks, int n_splits, int span,
                                       void* stream) {
  if (B <= 0 || KV <= 0 || H % KV || ctx <= 0 || d <= 0 || d > W || n_chunks <= 0 ||
      G * n_chunks < H / KV || n_splits <= 0 || span <= 0 || span > decode::MAX_SPAN ||
      (long long)n_splits * span < ctx || (pos_dtype != 0 && pos_dtype != 1) ||
      (long long)B * KV * n_chunks * n_splits > 0x7fffffff || (W > 256 && W % 256) ||
      W / 256 > 65535)
    return (int)cudaErrorInvalidValue;
  Params a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.pos = pos;
  a.out = out;
  a.ws = (float*)ws;
  a.counters = (int*)counters;
  a.H = H;
  a.KV = KV;
  a.ctx = ctx;
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
  if (dtype == F32) return (int)launch_t<float>(D, G, a, B, s);
  if (dtype == BF16) return (int)launch_t<__nv_bfloat16>(D, G, a, B, s);
  return (int)cudaErrorInvalidValue;
}
