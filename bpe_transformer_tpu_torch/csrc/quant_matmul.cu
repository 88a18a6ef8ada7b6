// Int8-weight matrix product with the dequantization in registers.
//
// Replaces: bpe_transformer_tpu/kernels/pallas/quant_matmul.py
//   quant_matmul (line 68; kernel _quant_matmul_kernel at 58, pallas_call at
//   103).
// Computes: y[i, o] = scale[o] * sum_c x[i, c] * q[o, c]
//   x (m, k) float32 or bfloat16, q (n, k) int8, scale (n,) float32 -> y
//   (m, n) float32.  The activations are never quantized: each int8 weight
//   is converted exactly and multiplied by the activation's value with
//   float32 accumulation; the scale (one per output channel, so the product
//   factors exactly) multiplies each output once, after the reduction.
//
// Bound on the H100: bytes at a decode tick (m = slots: the int8 weight is
// read once for a handful of rows, 2 m flops per weight byte; 0.0005 ms for
// 768 -> 2048 at m 8, 0.0073 for the 768 -> 32000 head), operations from a
// few hundred rows up at the bf16 tensor-core rate (2 m n k flops: 0.0008 ms
// for 768 -> 2048 at m 256, 0.0127 for the head).
//
// Two designs, picked by the wrapper (kernels/quant_matmul.py quant_path)
// before the launch:
//
// * Tensor cores (bf16 x, k a multiple of 16): the product runs transposed,
//   y^T = q x^T, on wgmma.  Every int8 value is exact in bf16 and a product
//   of two 8-bit significands is exact in float32, so a bf16 product with
//   float32 accumulators takes the same products as the float32 loop below;
//   only the order of the sums differs.  A block is one warpgroup owning 64
//   weight rows (the wgmma's M) and BN activation rows (its N: 8, 16, 32 or
//   64, the smallest that holds m, so a tick of 8 rows pads nothing; larger m
//   runs BN = 64 tiles on gridDim.y).  One thread streams 128-column K slices
//   through a four-stage ring with TMA: the int8 weight tile (64 rows of 128
//   bytes) and the two 64-column bf16 sub-tiles of x, both in the 128-byte
//   swizzle, one mbarrier a stage.  For each 16-column step the warpgroup
//   reads its A fragment straight from the int8 tile (two 32-bit words a row,
//   bank-conflict free under the swizzle) and widens it to bf16 in registers
//   with a byte permute: 0x4300 | (b & 0x7F) is 128 + the low seven bits,
//   0x4300 | (b & 0x80) is 128, or 256 when the sign bit is set, and one
//   packed bf16 subtraction of the two gives the int8 value exactly (four
//   integer/bf16x2 instructions a pair, where int -> float -> bf16 costs
//   quarter-rate conversions).  x's sub-tile is the K-major B operand.  The
//   weight bytes are read from device memory once; x (at most m k 2 bytes)
//   once per 64 weight rows, from L2.  A tick (m <= 64) has too few weight
//   tiles to fill 132 SMs, so the K slices are split over gridDim.z as
//   below (about two blocks per SM; none above m 64, where the partials
//   would outweigh the weights), and the fixed-order reduce kernel applies
//   the scale.  Why not the bf16 weight as a shared-memory operand: a widened
//   copy in shared memory triples its traffic there (a byte read, two
//   written, two read by wgmma) against one byte read into registers here,
//   and the tick is bound by how fast those bytes move.
// * CUDA cores (float32 x, which must keep float32 accuracy and may not use
//   TF32; bf16 rows that TMA cannot describe, k % 16 != 0: an int8 weight
//   row must be a multiple of 16 bytes long): a block computes an 8 x 256
//   tile of y (8 activation rows, 256 weight rows) over a slice of the
//   reduction axis.  Each step stages 16 columns: the 8 x 16 activations as
//   float32, and the 256 x 16 weights, one 16-byte load per weight row,
//   widened to float32 and stored transposed so that a thread reads its 4
//   weights of a column as one float4 (rows of the staged tile are padded by
//   4 floats against bank conflicts in the transposed store).  Thread t owns
//   weight rows 4t..4t+3 and all 8 activation rows: 32 float32
//   accumulators, 32 FMAs per staged column, the activations read as
//   broadcasts.  At a tick (m = 8) the weight tiles of one matrix are too few
//   to fill the card, so the reduction axis is split over gridDim.z blocks
//   (about two blocks per SM in all, at least 64 columns each); the splits
//   write float32 partials and a second kernel sums them in a fixed order and
//   applies the scale, so results do not vary from run to run.  Weight rows
//   whose length is not a multiple of 16 bytes (d_ff 683, 1365, 2731 give
//   such rows in w2) take a path of byte loads instead of the 16-byte loads;
//   nothing is refused for its alignment.

#include "common.cuh"
#include "hopper.cuh"

using namespace port;

namespace {

constexpr int BM = 8;    // activation rows per block
constexpr int BN = 256;  // weight rows per block (4 per thread)
constexpr int BK = 16;   // reduction columns per staged step
constexpr int NT = 64;   // threads per block

template <typename TX, bool VEC>
__global__ void __launch_bounds__(NT)
quant_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, float* __restrict__ y,
                    float* __restrict__ ws, int m, int n, int k, int k_per_split) {
  __shared__ __align__(16) float xs[BK][BM];
  __shared__ __align__(16) float qs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int kb = split * k_per_split;
  const int ke = min(k, kb + k_per_split);

  float acc[BM][4];
#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = kb; k0 < ke; k0 += BK) {
    __syncthreads();  // the previous step's tiles are consumed
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      xs[c][r] = (m0 + r < m && k0 + c < ke) ? to_f(x[(size_t)(m0 + r) * k + k0 + c]) : 0.f;
    }
    if (VEC) {
      // k % 16 == 0 and k0 % 16 == 0: every row's 16 columns are one
      // aligned 16-byte load.
#pragma unroll
      for (int j = 0; j < BN / NT; ++j) {
        const int r = tid + NT * j;
        float w[16];
        if (n0 + r < n) {
          load16(q + (size_t)(n0 + r) * k + k0, w);
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) w[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 16; ++e) qs[e][r] = w[e];
      }
    } else {
      for (int i = tid; i < BN * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        qs[c][r] = (n0 + r < n && k0 + c < ke) ? (float)q[(size_t)(n0 + r) * k + k0 + c] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      const float4 xa = *reinterpret_cast<const float4*>(&xs[c][0]);
      const float4 xb = *reinterpret_cast<const float4*>(&xs[c][4]);
      const float4 wq = *reinterpret_cast<const float4*>(&qs[c][4 * tid]);
      const float xv[BM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
      for (int r = 0; r < BM; ++r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] += xv[r] * wv[j];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int row = m0 + r;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tid + j;
      if (col >= n) continue;
      if (ws != nullptr) {
        ws[((size_t)split * m + row) * n + col] = acc[r][j];
      } else {
        y[(size_t)row * n + col] = acc[r][j] * scale[col];
      }
    }
  }
}

__global__ void quant_matmul_reduce_kernel(const float* __restrict__ ws,
                                           const float* __restrict__ scale, float* __restrict__ y,
                                           int nsplit, int n, size_t mn) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s) a += ws[(size_t)s * mn + i];
    y[i] = a * scale[i % n];
  }
}

// y = scale * (the nsplit float32 partials summed in a fixed order).
cudaError_t launch_reduce(const float* ws, const float* scale, float* y, int nsplit, int m, int n,
                          cudaStream_t stream) {
  const size_t mn = (size_t)m * n;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  quant_matmul_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, scale, y, nsplit, n, mn);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_t(const void* x, const int8_t* q, const float* scale, float* ws, float* y,
                     int m, int n, int k, int nsplit, int k_per_split, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, nsplit), block(NT);
  float* part = nsplit > 1 ? ws : nullptr;
  const bool vec = k % 16 == 0 && k_per_split % BK == 0 && ((uintptr_t)q) % 16 == 0;
  if (vec) {
    quant_matmul_kernel<TX, true><<<grid, block, 0, stream>>>((const TX*)x, q, scale, y, part, m,
                                                              n, k, k_per_split);
  } else {
    quant_matmul_kernel<TX, false><<<grid, block, 0, stream>>>((const TX*)x, q, scale, y, part, m,
                                                               n, k, k_per_split);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return launch_reduce(ws, scale, y, nsplit, m, n, stream);
}


// ----------------------------------------------------------- tensor cores

namespace tc {

using namespace port::sm90;

constexpr int BW = 64;       // weight rows per block: the wgmma's M
constexpr int KS = 128;      // K columns per stage: one 128-byte int8 row
constexpr int STAGES = 4;
constexpr int NT = 128;      // one warpgroup
constexpr int W_BYTES = BW * KS;

template <int BN> struct Smem {
  static constexpr int X_BYTES = 2 * BN * 128;  // two 64-column bf16 sub-tiles
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + STAGES * 8 + 1024;  // + slack to align to 1024
};

// Bytes sel (0x4140: bytes 0, 1; 0x4342: bytes 2, 3) of w, two int8
// values, as an exact bf16 pair (low half the first byte).
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w, uint32_t sel) {
  const uint32_t spread = __byte_perm(w, 0u, sel);              // [b0, 0, b1, 0]
  const uint32_t lo = (spread & 0x007F007Fu) | 0x43004300u;     // 128 + low seven bits
  const uint32_t hi = (spread & 0x00800080u) | 0x43004300u;     // 128, or 256 if negative
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                                   *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <int BN>
__device__ __forceinline__ void load_stage(uint8_t* st, uint64_t* bar, const CUtensorMap* tq,
                                           const CUtensorMap* tx, int slice, int n0, int m0) {
  mbar_expect_tx(bar, Smem<BN>::STAGE);
  tma_load_2d(st, tq, bar, slice * KS, n0);
  tma_load_2d(st + W_BYTES, tx, bar, slice * KS, m0);
  tma_load_2d(st + W_BYTES + BN * 128, tx, bar, slice * KS + 64, m0);
}

// One block: y^T rows n0..n0+63 (weights) x columns m0..m0+BN-1
// (activations) over K slices [split * per, min(steps, (split + 1) * per)).
template <int BN>
__global__ void __launch_bounds__(NT)
quant_matmul_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_x, const float* __restrict__ scale,
                       float* __restrict__ y, float* __restrict__ ws, int m, int n, int k,
                       int per) {
  using L = Smem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int n0 = blockIdx.x * BW, m0 = blockIdx.y * BN, split = blockIdx.z;
  const int steps = (k + KS - 1) / KS;
  const int s0 = split * per;
  const int ns = min(steps, s0 + per) - s0;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < STAGES && i < ns; ++i)
      load_stage<BN>(sm + i * L::STAGE, &full[i], &tm_q, &tm_x, s0 + i, n0, m0);
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // This thread's A rows r and r + 8 share r % 8 = g, so one swizzled chunk
  // position serves both; its two columns of each 8-column half are bytes
  // 2 (c % 2), +1 of word c / 2 of that half.
  const int r = warp * 16 + g;
  const uint32_t sel = (c & 1) ? 0x4342u : 0x4140u;

  for (int it = 0; it < ns; ++it) {
    const int st = it % STAGES;
    mbar_wait(&full[st], (it / STAGES) & 1);
    const uint8_t* wt = sm + st * L::STAGE;
    const uint8_t* xt = wt + W_BYTES;
    uint32_t a[KS / 16][4];
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      const uint8_t* c0 = wt + r * 128 + ((kk ^ g) * 16) + 4 * (c >> 1);
      const uint8_t* c1 = c0 + 8 * 128;  // row r + 8
      a[kk][0] = i8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(c0), sel);
      a[kk][1] = i8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(c1), sel);
      a[kk][2] = i8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(c0 + 8), sel);
      a[kk][3] = i8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(c1 + 8), sel);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk)
      wgmma_rs_k<BN>(acc, a[kk], desc_sw128(xt + (kk >> 2) * BN * 128) + (kk & 3) * 2);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) fence_regs(a[kk]);
    __syncthreads();  // the stage is consumed
    if (tid == 0 && it + STAGES < ns)
      load_stage<BN>(sm + st * L::STAGE, &full[st], &tm_q, &tm_x, s0 + it + STAGES, n0, m0);
  }

  // acc[4 j + e]: weight row n0 + r + 8 (e / 2), activation row
  // m0 + 8 j + 2 c + e % 2.
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = n0 + r + 8 * (e >> 1);
      const int i = m0 + 8 * j + 2 * c + (e & 1);
      if (o >= n || i >= m) continue;
      if (ws != nullptr) {
        ws[((size_t)split * m + i) * n + o] = acc[4 * j + e];
      } else {
        y[(size_t)i * n + o] = acc[4 * j + e] * scale[o];
      }
    }
  }
}

template <int BN>
cudaError_t launch_bn(const void* x, const void* q, const float* scale, float* ws, float* y,
                      int m, int n, int k, int nsplit, int per, cudaStream_t stream) {
  CUtensorMap tq, tx;
  const uint64_t dq[2] = {(uint64_t)k, (uint64_t)n}, dx[2] = {(uint64_t)k, (uint64_t)m};
  const uint32_t box_q[2] = {KS, BW}, box_x[2] = {64, BN};
  if (!encode_u8(&tq, q, 2, dq, box_q) || !encode_bf16(&tx, x, 2, dx, box_x))
    return cudaErrorInvalidValue;
  static int ready = -1;
  const cudaError_t err = allow_smem(quant_matmul_tc_kernel<BN>, Smem<BN>::BYTES, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BW - 1) / BW, (m + BN - 1) / BN, nsplit);
  quant_matmul_tc_kernel<BN><<<grid, NT, Smem<BN>::BYTES, stream>>>(
      tq, tx, scale, y, nsplit > 1 ? ws : nullptr, m, n, k, per);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x (m, k) in the dtype code's type, q (n, k) int8, scale (n,) float32,
// y (m, n) float32, all contiguous; ws float32 (nsplit, m, n) scratch when
// nsplit > 1 (else unused).  The reduction axis is cut into nsplit slices of
// k_per_split columns (a multiple of 16).
extern "C" int quant_matmul_launch(int dtype, const void* x, const void* q, const void* scale,
                                   void* ws, void* y, int m, int n, int k, int nsplit,
                                   int k_per_split, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || nsplit <= 0 || nsplit > 65535 || k_per_split <= 0 ||
      (long long)nsplit * k_per_split < k || (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (nsplit > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int8_t* qp = (const int8_t*)q;
  const float* sp = (const float*)scale;
  float* wp = (float*)ws;
  float* yp = (float*)y;
  if (dtype == F32) return (int)launch_t<float>(x, qp, sp, wp, yp, m, n, k, nsplit, k_per_split, s);
  if (dtype == BF16)
    return (int)launch_t<__nv_bfloat16>(x, qp, sp, wp, yp, m, n, k, nsplit, k_per_split, s);
  return (int)cudaErrorInvalidValue;
}

// bf16 only, on the tensor cores: x (m, k) bf16, q (n, k) int8, scale (n,)
// float32, y (m, n) float32, all contiguous and 16-byte aligned, k a
// multiple of 16; ws float32 (nsplit, m, n) scratch when nsplit > 1.  The
// K axis is cut into 128-column slices, `per` of them a split; bn (8, 16,
// 32 or 64) activation rows a block.
extern "C" int quant_matmul_tc_launch(int dtype, const void* x, const void* q, const void* scale,
                                      void* ws, void* y, int m, int n, int k, int nsplit, int per,
                                      int bn, void* stream) {
  const int steps = (k + tc::KS - 1) / tc::KS;
  if (dtype != BF16 || m <= 0 || n <= 0 || k <= 0 || k % 16 || nsplit <= 0 || nsplit > 65535 ||
      per <= 0 || (long long)nsplit * per < steps || (long long)(nsplit - 1) * per >= steps ||
      (m + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidValue;
  if (nsplit > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* sp = (const float*)scale;
  float* wp = (float*)ws;
  float* yp = (float*)y;
  cudaError_t err;
  switch (bn) {
    case 8: err = tc::launch_bn<8>(x, q, sp, wp, yp, m, n, k, nsplit, per, s); break;
    case 16: err = tc::launch_bn<16>(x, q, sp, wp, yp, m, n, k, nsplit, per, s); break;
    case 32: err = tc::launch_bn<32>(x, q, sp, wp, yp, m, n, k, nsplit, per, s); break;
    case 64: err = tc::launch_bn<64>(x, q, sp, wp, yp, m, n, k, nsplit, per, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  return (int)launch_reduce(wp, sp, yp, nsplit, m, n, s);
}
