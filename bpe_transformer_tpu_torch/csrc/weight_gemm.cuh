// A skinny product on the tensor cores: y^T = w x^T for a few activation
// rows x (m, k) bf16 against a weight w (n, k) stored as int8 (with a float32
// scale per weight row) or as bf16; y (m, n) float32.  The int8-weight
// matmul (quant_matmul.cu, m = slots or a prefill chunk) and the head
// projection of the sampling tails (sample.cu, m = the rows to sample or
// verify) both run it.
//
// A block is one warpgroup owning 64 weight rows (the wgmma's M) and BN
// activation rows (its N: a multiple of 8 up to 64, the smallest that holds
// m, so 8 rows pad nothing and 40 rows run as N 40; larger m runs BN = 64
// tiles on gridDim.y).  One thread streams 128-column K slices through a
// four-stage ring with TMA: the weight tile (64 rows of 128 int8, or two
// 64-column sub-tiles of 64 bf16 rows) and the two 64-column bf16 sub-tiles
// of x, all in the 128-byte swizzle, one mbarrier a stage.  For each
// 16-column step the warpgroup reads its A fragment straight from the
// weight tile (two 32-bit words a row, bank-conflict free under the
// swizzle); an int8 word is widened to an exact bf16 pair in registers by a
// byte permute: 0x4300 | (b & 0x7F) is 128 + the low seven bits,
// 0x4300 | (b & 0x80) is 128, or 256 when the sign bit is set, and one
// packed bf16 subtraction of the two gives the int8 value exactly (four
// integer/bf16x2 instructions a pair, where int -> float -> bf16 costs
// quarter-rate conversions).  x's sub-tile is the K-major B operand.  Every
// int8 value is exact in bf16 and a product of two bf16 values is exact in
// float32, so the products are those of a float32 loop over the same
// values; only the order of the float32 sums differs.  The weight bytes are
// read from device memory once; x (at most m k 2 bytes) once per 64 weight
// rows, from L2.
//
// With few weight tiles (a decode tick's matrices) the K slices may be split
// over gridDim.z; the splits then write float32 partials to ws, which the
// caller reduces in a fixed order and scales.  Without a split the epilogue
// writes y, times the row's scale for an int8 weight.

#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace port {
namespace wgemm {
// Internal linkage: each library that includes this header keeps its own
// kernels and its own once-per-device shared-memory opt-ins (a template's
// function-local static would otherwise be one object across libraries).
namespace {

using namespace port::sm90;

constexpr int BW = 64;   // weight rows per block: the wgmma's M
constexpr int KS = 128;  // K columns per stage
constexpr int STAGES = 4;
constexpr int NT = 128;  // one warpgroup

template <typename TW, int BN>
struct Smem {
  static constexpr int W_BYTES = BW * KS * (int)sizeof(TW);  // int8: one tile; bf16: two sub-tiles
  static constexpr int X_BYTES = 2 * BN * 128;               // two 64-column bf16 sub-tiles
  static constexpr int STAGE = W_BYTES + X_BYTES;            // a multiple of 1024 for BN % 8 == 0
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

template <typename TW, int BN>
__device__ __forceinline__ void load_stage(uint8_t* st, uint64_t* bar, const CUtensorMap* tw,
                                           const CUtensorMap* tx, int slice, int n0, int m0) {
  using L = Smem<TW, BN>;
  mbar_expect_tx(bar, L::STAGE);
  tma_load_2d(st, tw, bar, slice * KS, n0);
  if constexpr (std::is_same<TW, __nv_bfloat16>::value)
    tma_load_2d(st + L::W_BYTES / 2, tw, bar, slice * KS + 64, n0);
  tma_load_2d(st + L::W_BYTES, tx, bar, slice * KS, m0);
  tma_load_2d(st + L::W_BYTES + BN * 128, tx, bar, slice * KS + 64, m0);
}

// The A fragment of 16-column step kk of a stage's weight tile for thread
// (row r of the block, r % 8 = g; c = lane % 4): rows r and r + 8 share one
// swizzled chunk position, columns 2 c, +1 and 8 + 2 c, +1 of the step.
template <typename TW>
__device__ __forceinline__ void a_fragment(const uint8_t* wt, int kk, int r, int g, int c,
                                           uint32_t (&a)[4]) {
  if constexpr (std::is_same<TW, int8_t>::value) {
    // A 128-byte row holds the slice's 128 columns: the step's 16 bytes are
    // chunk kk; the two columns are bytes 2 (c % 2), +1 of word c / 2 of
    // each 8-column half.
    const uint32_t sel = (c & 1) ? 0x4342u : 0x4140u;
    const uint8_t* c0 = wt + r * 128 + ((kk ^ g) * 16) + 4 * (c >> 1);
    const uint8_t* c1 = c0 + 8 * 128;  // row r + 8
    a[0] = i8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(c0), sel);
    a[1] = i8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(c1), sel);
    a[2] = i8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(c0 + 8), sel);
    a[3] = i8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(c1 + 8), sel);
  } else {
    // Sub-tile kk / 4 holds 64 columns a row: the step's 16 columns are
    // chunks 2 (kk % 4) and the next, word c of each.
    const uint8_t* sub = wt + (kk >> 2) * (BW * 128) + r * 128 + 4 * c;
    const int ch = 2 * (kk & 3);
    a[0] = *reinterpret_cast<const uint32_t*>(sub + ((ch ^ g) * 16));
    a[1] = *reinterpret_cast<const uint32_t*>(sub + 8 * 128 + ((ch ^ g) * 16));
    a[2] = *reinterpret_cast<const uint32_t*>(sub + (((ch + 1) ^ g) * 16));
    a[3] = *reinterpret_cast<const uint32_t*>(sub + 8 * 128 + (((ch + 1) ^ g) * 16));
  }
}

// One block: y^T rows n0..n0+63 (weights) x columns m0..m0+BN-1
// (activations) over K slices [split * per, min(steps, (split + 1) * per)).
// scale: an int8 weight's per-row scale (a bf16 weight has none); ws
// non-null for a split K axis.
template <typename TW, int BN>
__global__ void __launch_bounds__(NT)
wgemm_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
             const float* __restrict__ scale, float* __restrict__ y, float* __restrict__ ws,
             int m, int n, int k, int per) {
  using L = Smem<TW, BN>;
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
      load_stage<TW, BN>(sm + i * L::STAGE, &full[i], &tm_w, &tm_x, s0 + i, n0, m0);
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int r = warp * 16 + g;

  for (int it = 0; it < ns; ++it) {
    const int st = it % STAGES;
    mbar_wait(&full[st], (it / STAGES) & 1);
    const uint8_t* wt = sm + st * L::STAGE;
    const uint8_t* xt = wt + L::W_BYTES;
    uint32_t a[KS / 16][4];
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) a_fragment<TW>(wt, kk, r, g, c, a[kk]);
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
      load_stage<TW, BN>(sm + st * L::STAGE, &full[st], &tm_w, &tm_x, s0 + it + STAGES, n0, m0);
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
        if constexpr (std::is_same<TW, int8_t>::value) {
          y[(size_t)i * n + o] = acc[4 * j + e] * scale[o];
        } else {
          y[(size_t)i * n + o] = acc[4 * j + e];
        }
      }
    }
  }
}

template <typename TW, int BN>
cudaError_t launch_bn(const void* x, const void* w, const float* scale, float* ws, float* y,
                      int m, int n, int k, int nsplit, int per, cudaStream_t stream) {
  CUtensorMap tw, tx;
  const uint64_t dw[2] = {(uint64_t)k, (uint64_t)n}, dx[2] = {(uint64_t)k, (uint64_t)m};
  const uint32_t box_x[2] = {64, BN};
  bool ok;
  if constexpr (std::is_same<TW, int8_t>::value) {
    const uint32_t box_w[2] = {KS, BW};
    ok = encode_u8(&tw, w, 2, dw, box_w);
  } else {
    const uint32_t box_w[2] = {64, BW};
    ok = encode_bf16(&tw, w, 2, dw, box_w);
  }
  if (!ok || !encode_bf16(&tx, x, 2, dx, box_x)) return cudaErrorInvalidValue;
  static int ready = -1;
  const cudaError_t err = allow_smem(wgemm_kernel<TW, BN>, Smem<TW, BN>::BYTES, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BW - 1) / BW, (m + BN - 1) / BN, nsplit);
  wgemm_kernel<TW, BN><<<grid, NT, Smem<TW, BN>::BYTES, stream>>>(
      tw, tx, scale, y, nsplit > 1 ? ws : nullptr, m, n, k, per);
  return cudaGetLastError();
}

// x (m, k) bf16 and w (n, k) int8 or bf16, both contiguous with 16-byte
// aligned rows (k % 16 == 0 for int8, k % 8 == 0 for bf16); bn a multiple
// of 8 up to 64 activation rows a block; the K axis in nsplit splits of
// `per` 128-column slices (ws (nsplit, m, n) float32 when nsplit > 1).
template <typename TW>
cudaError_t launch(int bn, const void* x, const void* w, const float* scale, float* ws, float* y,
                   int m, int n, int k, int nsplit, int per, cudaStream_t s) {
  switch (bn) {
    case 8: return launch_bn<TW, 8>(x, w, scale, ws, y, m, n, k, nsplit, per, s);
    case 16: return launch_bn<TW, 16>(x, w, scale, ws, y, m, n, k, nsplit, per, s);
    case 24: return launch_bn<TW, 24>(x, w, scale, ws, y, m, n, k, nsplit, per, s);
    case 32: return launch_bn<TW, 32>(x, w, scale, ws, y, m, n, k, nsplit, per, s);
    case 40: return launch_bn<TW, 40>(x, w, scale, ws, y, m, n, k, nsplit, per, s);
    case 48: return launch_bn<TW, 48>(x, w, scale, ws, y, m, n, k, nsplit, per, s);
    case 56: return launch_bn<TW, 56>(x, w, scale, ws, y, m, n, k, nsplit, per, s);
    case 64: return launch_bn<TW, 64>(x, w, scale, ws, y, m, n, k, nsplit, per, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace wgemm
}  // namespace port
