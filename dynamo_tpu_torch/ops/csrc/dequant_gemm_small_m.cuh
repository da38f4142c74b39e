// Dequant-GEMM bodies for decode and verification shapes (M <= 80 rows of
// x): out[M, N] = x[M, K] @ W[K, N], x bf16, f32 accumulation, bf16 out.
// Two modes: W4A16 (q4_small_m: W packed int4 [K/2, N], per-group f32
// scale and zero rows; q4_matmul.cu, both pack layouts) and W8A16
// (q8_small_m: W int8 [K, N], per-column f32 scale; q8_matmul.cu). Above
// M = 80 both modes run dequant_gemm.cuh's prefill body.
//
// Bound on this card: the weight stream from HBM for every M up to 80 (q4
// K * N / 2 bytes, 146 MB over mistral-7b's five projections; q8 K * N,
// 274 MB): the operations, 2 * M * K * N, reach the bytes' time near
// M = 70 (q4) or past M = 80 (q8) only at the bf16 tensor cores' dense
// (wgmma) peak. Measured for q4 (chip_smoke.py's gemm phase, NVIDIA H100
// 80GB HBM3, 700 W; see PERF.md section 6): ~3.4x the bound at M = 8-16 and
// ~6x at M = 80, where mma.sync issue (5 MMAs per 4 output fragments, 4.)
// and the x tile each block stages (2.5x the packed weight's bytes at
// M = 80) hold it back.
//
// Design, against the three causes that held the old 16 x 64 / 64 x 128
// wmma tiles at 3.9x (q8) to ~11x (q4) the bound:
//   1. Too few blocks. Split-K across blocks: the grid is (column tiles,
//      n_split); block (c, s) contracts rows [s * span, (s+1) * span) (q4:
//      packed rows). The host's plan (shapes only: ops/q4_linear.py
//      q4_split_plan, ops/q8_linear.py q8_split_plan) puts every boundary on
//      a ring stage, and for q4 on a whole quantization group of both
//      nibble runs, so a split never straddles a scale/zero row. With one
//      split the block writes bf16 itself; with several each writes f32
//      partials [n_split, M, N] to the wrapper's workspace and
//      reduce_splits sums them in split order (deterministic), applies the
//      q8 column scale, and casts.
//   2. Too few bytes in flight. A cp.async ring of kStages stages (6 at
//      M <= 16, 4 above), each 32 rows of the column tile and the x columns
//      they multiply (rows past M are zeroed once and never copied); q4: a
//      group's last stage also brings the group's scale and zero rows and
//      the next group's scale rows. kStages - 1 stages stay in flight while
//      one is multiplied.
//   3. Converted once, no shared-memory round trip. One block covers all
//      M <= 80 rows, so each weight byte is converted once per launch.
//      Each thread reads 32-bit words of codes (4 columns) straight from the
//      ring and turns them in registers into mma.sync m16n8k16 B
//      fragments: k rows 2t, 2t+1, 2t+8, 2t+9 of the fragment are ring rows
//      r0 + those (A fragments come from ldmatrix as usual). The column
//      permutation that makes a word useful: in a warp's 32 columns,
//      fragment j's column g is column 4g + j, so the accumulator c0/c1 of
//      lane (g, t) land in columns 8t + j and 8t + 4 + j. q4: warps come in
//      pairs per 32 columns, one takes the low nibbles (the low run), one
//      the high (the x tile holds both runs side by side). q8: one code run,
//      so every warp owns 32 columns over the whole stage, and a lane's
//      8 consecutive columns leave the accumulators as one 16-byte store.
//   4. q4: dequant costs two instructions per pair of weights: the zero
//      point and scale fold out of the contraction, as in the reference
//      kernel,
//        sum_k x (u - z) s = s (sum_k x (128 + u) - (128 + z) sum_k x)
//      per group. A B fragment is the raw codes as bf16 128 + u (exact):
//      one prmt puts byte j of two packed rows side by side, one lop3
//      keeps a nibble under the bf16 exponent of 128. A fifth MMA against
//      ones gives sum_k x. The accumulators hold the run's sum in units of
//      1 / s of the current group (per column): at a group's end the warp
//      takes off (128 + z) sum_k x and rescales by s / s_next (by s after
//      the split's last group), so no second set of per-group partials
//      takes registers. The weight is never rounded to bf16 (the plain
//      version rounds (u - z) * s), so the two differ by that rounding.
//   5. q8: 128 + u does not carry over (an int8 code needs 8 bits and a
//      sign, a bf16 holds 8 significant bits), so a code goes through an
//      exact f32: one lop3 per word (q + 128 as unsigned bytes), one prmt
//      into the f32 2^23 + 128 + q and one fadd per code, one prmt per pair
//      keeping the two exact high halves: ~2.75 instructions a code
//      (dq::q8_f32x4, dq::int_f32_bf16x2). No fold, no zero point, no
//      fifth MMA: the column scale lands once on the f32 sum, in the
//      epilogue with one split or in reduce_splits with several.
//   Not done: the swapped product at M <= 8, and a wgmma / TMA body that
//   beats this one at M = 40-80 (PERF.md section 6 names two that did not).

#pragma once

#include "dequant_gemm.cuh"

namespace dqs {

using bf16 = __nv_bfloat16;
using dq::cp_async16;
using dq::cp_async_commit;
using dq::cp_async_wait;
using dq::ldmatrix_x4;
using dq::mma_bf16;
using dq::pack_bf16x2;
using dq::smem_addr;

constexpr int kStageRows = 32;  // packed (q4) or code (q8) rows per stage
constexpr int kMaxRows = 80;    // the most x rows one block holds
constexpr int kV1 = dq::kQ4V1;
constexpr int kV2 = dq::kQ4V2;

// bf16 pair (128 + low nibble of a's byte j, 128 + low nibble of b's).
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t a, uint32_t b,
                                                 int j) {
  return (__byte_perm(a, b, j | ((4 + j) << 8)) & 0x000F000Fu) | 0x43004300u;
}

// MF 16-row fragments of x (16 * MF rows); 2 * WN warps: WN column groups
// of 32 columns, times the low and the high nibble run.
template <int MF, int WN>
struct Shape {
  static constexpr int kRows = 16 * MF;
  static constexpr int kBN = 32 * WN;             // output columns per block
  static constexpr int kThreads = 64 * WN;
  static constexpr int kStages = MF == 1 ? 6 : 4;
  static constexpr int kMinBlocks = MF == 1 ? 5 : 2;  // resident per SM
  static constexpr int kWP = kBN + 16;            // bytes per packed row
  static constexpr int kXP = 2 * kStageRows + 8;  // bf16 per x row
  static constexpr int kW = kStageRows * kWP;
  static constexpr int kX = kRows * kXP * 2;
  // s_lo, z_lo, s_hi, z_hi of the stage's groups, then s_lo, s_hi of the
  // next groups (loaded on a group's last stage only)
  static constexpr int kSZ = 6 * kBN * 4;
  static constexpr int kStage = kW + kX + kSZ;
  static constexpr int kCP = kBN + 4;             // f32 epilogue pitch
  static constexpr int kEpi = kRows * kCP * 4;
  static constexpr int kSmem =
      kStages * kStage > kEpi ? kStages * kStage : kEpi;
  static_assert(WN == 2 || WN == 4, "2 or 4 column groups");
  static_assert(kW % 16 == 0 && kX % 16 == 0 && kSZ % 16 == 0, "16B parts");
};

// x [M, K] bf16; w packed [K/2, N]; s, z [K/group, N] f32; out [M, N] bf16
// when part is null (one split), else part [gridDim.y, M, N] f32. `half`
// is the layout's distance between a byte's two code rows (v1 group / 2,
// v2 K / 2); `span` the packed rows of a split, a whole number of groups.
template <int MODE, int MF, int WN>
__global__ void __launch_bounds__(Shape<MF, WN>::kThreads,
                                  Shape<MF, WN>::kMinBlocks)
q4_small_m(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
           const float* __restrict__ s, const float* __restrict__ z,
           bf16* __restrict__ out, float* __restrict__ part, int M, int N,
           int K, int group, int half, int span) {
  using S = Shape<MF, WN>;
  constexpr int kThreads = S::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wn = warp % WN;
  const int run = warp / WN;  // 0: the low nibbles, 1: the high nibbles
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * S::kBN;
  const int split = blockIdx.y;
  const int p_begin = split * span;
  const int p_end = min(p_begin + span, K / 2);
  const int n_it = (p_end - p_begin) / kStageRows;
  // A quantization group is `unit` packed rows (the low nibbles of a byte
  // row lie in one group of code rows, the high nibbles in one group);
  // splits start on a group, so stage it of this block is stage
  // it % spg of group gi0 + it / spg.
  const int unit = MODE == kV1 ? group / 2 : group;
  const int spg = unit / kStageRows;
  const int gi0 = p_begin / unit;
  const int gi_end = gi0 + (p_end - p_begin) / unit;
  const int g_hi_off = MODE == kV2 ? half / group : 0;

  auto ring_w = [&](int slot) { return smem + slot * S::kStage; };
  auto ring_x = [&](int slot) {
    return reinterpret_cast<bf16*>(smem + slot * S::kStage + S::kW);
  };
  auto ring_sz = [&](int slot) {
    return reinterpret_cast<float*>(smem + slot * S::kStage + S::kW + S::kX);
  };

  // x rows past M stay zero in every slot; the copies below skip them.
  for (int i = tid; i < S::kStages * (S::kRows - M) * 8; i += kThreads) {
    const int slot = i / ((S::kRows - M) * 8);
    const int r = i % ((S::kRows - M) * 8);
    *reinterpret_cast<uint4*>(ring_x(slot) + (M + r / 8) * S::kXP
                              + (r % 8) * 8) = make_uint4(0, 0, 0, 0);
  }

  // Issue the next stage's copies into ring slot `slot`; stages are loaded
  // in order, so (ld_g, ld_r) just counts forward.
  int ld_g = gi0;
  int ld_r = 0;
  auto load = [&](int slot) {
    const int p0 = ld_g * unit + ld_r * kStageRows;
    const int c_lo = ld_g * group + ld_r * kStageRows;
    const int c_hi = c_lo + half;
    const int g_lo = ld_g;
    const int g_last = ld_r == spg - 1;
    const int n_rows = ld_g + 1 < gi_end ? 6 : 4;  // the next group's s too
    if (++ld_r == spg) {
      ld_r = 0;
      ++ld_g;
    }
    unsigned char* ws = ring_w(slot);
    constexpr int kWC = S::kBN / 16;  // 16-byte chunks per packed row
#pragma unroll
    for (int c = tid; c < kStageRows * kWC; c += kThreads) {
      const int r = c / kWC;
      const int n = n0 + (c % kWC) * 16;
      const bool ok = n < N;
      cp_async16(smem_addr(ws + r * S::kWP + (c % kWC) * 16),
                 ok ? w + (int64_t)(p0 + r) * N + n : w, ok);
    }
    bf16* xs = ring_x(slot);
    for (int c = tid; c < M * 8; c += kThreads) {
      const int m = c >> 3;
      const int j = c & 7;
      const int k = j < 4 ? c_lo + 8 * j : c_hi + 8 * (j - 4);
      cp_async16(smem_addr(xs + m * S::kXP + 8 * j), x + (int64_t)m * K + k,
                 true);
    }
    if (g_last) {  // the scale and zero rows the fold at this stage reads
      float* sz = ring_sz(slot);
      constexpr int kSC = S::kBN / 4;  // 16-byte chunks per row
      for (int c = tid; c < n_rows * kSC; c += kThreads) {
        const int row = c / kSC;  // s_lo, z_lo, s_hi, z_hi, next s_lo, s_hi
        const int n = n0 + (c % kSC) * 4;
        const bool ok = n < N;
        const int gr = (row < 4 ? g_lo : g_lo + 1)
                       + ((row == 2 || row == 3 || row == 5) ? g_hi_off : 0);
        const float* src = ((row == 1 || row == 3) ? z : s)
                           + (int64_t)gr * N + n;
        cp_async16(smem_addr(sz + row * S::kBN + (c % kSC) * 4),
                   ok ? src : s, ok);
      }
    }
  };

  // acc: this warp's run's products with the raw codes, sum x (128 + u),
  // kept in units of 1 / s of the current group (per column); csum: the
  // group's sums of x (row g in [0], row g + 8 in [2]).
  float acc[MF][4][4];
  float csum[MF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      csum[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][e] = 0.f;
    }

#pragma unroll
  for (int st = 0; st < S::kStages - 1; ++st) {
    if (st < n_it) load(st);
    cp_async_commit();
  }

  const int col = wn * 32 + 4 * g;  // this thread's 4 columns of the tile
  int cm_r = 0;                     // the stage's index within its group
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<S::kStages - 2>();
    __syncthreads();  // stage `it` landed; slot (it - 1) % kStages is free
    const int nxt = it + S::kStages - 1;
    if (nxt < n_it) load(nxt % S::kStages);
    cp_async_commit();

    const int slot = it % S::kStages;
    const unsigned char* ws = ring_w(slot);
    const bf16* xs = ring_x(slot);
#pragma unroll
    for (int pr = 0; pr < kStageRows / 16; ++pr) {
      const int r0 = pr * 16;
      uint32_t word[4];  // packed rows r0 + 2t, 2t + 1, 2t + 8, 2t + 9
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + 2 * t + (q & 1) + (q >> 1) * 8;
        word[q] = *reinterpret_cast<const uint32_t*>(ws + r * S::kWP + col);
        if (MODE == kV2) word[q] ^= 0x88888888u;  // signed-biased nibbles
        if (run) word[q] >>= 4;
      }
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = codes_bf16x2(word[0], word[1], j);
        b[j][1] = codes_bf16x2(word[2], word[3], j);
      }
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(xs + (mf * 16 + (lane & 15)) * S::kXP
                                 + run * kStageRows + r0 + (lane >> 4) * 8));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mf][j], a, b[j][0], b[j][1]);
        mma_bf16(csum[mf], a, 0x3F803F80u, 0x3F803F80u);  // x . ones
      }
    }

    if (++cm_r == spg) {  // the group's last stage: fold the group in
      cm_r = 0;
      // sum_k x (u - z) s = s (sum_k x (128 + u) - (128 + z) sum_k x): take
      // off (128 + z) sum_k x, then rescale to 1 / s of the next group, or
      // by s after the split's last group. This thread's accumulator
      // columns are 8t .. 8t + 7 of its warp's 32.
      const float* sr = ring_sz(slot) + 2 * run * S::kBN + wn * 32 + 8 * t;
      const float* nr = sr + (4 - run) * S::kBN;  // the next group's s
      const bool next = it + 1 < n_it;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // columns 8t + j (a) and 8t + 4 + j (b)
        const float za = sr[S::kBN + j] + 128.f;
        const float zb = sr[S::kBN + 4 + j] + 128.f;
        const float ra = next ? sr[j] / nr[j] : sr[j];
        const float rb = next ? sr[4 + j] / nr[4 + j] : sr[4 + j];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          float* p = acc[mf][j];
          p[0] = (p[0] - za * csum[mf][0]) * ra;
          p[1] = (p[1] - zb * csum[mf][0]) * rb;
          p[2] = (p[2] - za * csum[mf][2]) * ra;
          p[3] = (p[3] - zb * csum[mf][2]) * rb;
        }
      }
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int e = 0; e < 4; ++e) csum[mf][e] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes the epilogue tile

  // Epilogue: the two runs' warps of each column group add into one f32
  // tile in turn, then the block writes rows < M and columns < N.
  float* cs = reinterpret_cast<float*>(smem);  // [kRows][kCP]
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (run == pass) {
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* p0 = cs + (mf * 16 + g) * S::kCP + wn * 32 + 8 * t + j;
          float* p1 = p0 + 8 * S::kCP;
          if (pass == 0) {
            p0[0] = acc[mf][j][0];
            p0[4] = acc[mf][j][1];
            p1[0] = acc[mf][j][2];
            p1[4] = acc[mf][j][3];
          } else {
            p0[0] += acc[mf][j][0];
            p0[4] += acc[mf][j][1];
            p1[0] += acc[mf][j][2];
            p1[4] += acc[mf][j][3];
          }
        }
    }
    __syncthreads();
  }
  constexpr int kQC = S::kBN / 4;  // 4-column chunks per row
  for (int c = tid; c < M * kQC; c += kThreads) {
    const int m = c / kQC;
    const int q = (c % kQC) * 4;
    const int n = n0 + q;
    if (n >= N) continue;
    const float4 v = *reinterpret_cast<const float4*>(cs + m * S::kCP + q);
    if (part == nullptr) {
      uint2 o;
      o.x = pack_bf16x2(v.x, v.y);
      o.y = pack_bf16x2(v.z, v.w);
      *reinterpret_cast<uint2*>(out + (int64_t)m * N + n) = o;
    } else {
      *reinterpret_cast<float4*>(part + ((int64_t)split * M + m) * N + n) = v;
    }
  }
}

// ---- W8A16 (row 5) ----------------------------------------------------------

// MF 16-row fragments of x (16 * MF rows); WN warps of 32 columns each, every
// warp over the whole 32-row stage.
template <int MF, int WN>
struct Q8Shape {
  static constexpr int kRows = 16 * MF;
  static constexpr int kBN = 32 * WN;             // output columns per block
  static constexpr int kThreads = 32 * WN;
  static constexpr int kStages = MF == 1 ? 6 : 4;
  static constexpr int kMinBlocks = MF == 1 ? 6 : (WN > 4 ? 2 : 3);
  static constexpr int kWP = kBN + 16;            // bytes per code row
  static constexpr int kXP = kStageRows + 8;      // bf16 per x row
  static constexpr int kW = kStageRows * kWP;
  static constexpr int kX = kRows * kXP * 2;
  static constexpr int kStage = kW + kX;
  static constexpr int kSmem = kStages * kStage;
  static_assert(kW % 16 == 0 && kX % 16 == 0, "16-byte parts");
};

// x [M, K] bf16; w int8 [K, N]; s [N] f32; out [M, N] bf16 (x @ w * s) when
// part is null (one split), else part [gridDim.y, M, N] f32 (x @ w over the
// split's rows, unscaled). `span` is the code rows of a split, a whole
// number of stages.
template <int MF, int WN>
__global__ void __launch_bounds__(Q8Shape<MF, WN>::kThreads,
                                  Q8Shape<MF, WN>::kMinBlocks)
q8_small_m(const bf16* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ s, bf16* __restrict__ out,
           float* __restrict__ part, int M, int N, int K, int span) {
  using S = Q8Shape<MF, WN>;
  constexpr int kThreads = S::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wn = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * S::kBN;
  const int split = blockIdx.y;
  const int k_begin = split * span;
  const int n_it = (min(k_begin + span, K) - k_begin) / kStageRows;

  auto ring_w = [&](int slot) { return smem + slot * S::kStage; };
  auto ring_x = [&](int slot) {
    return reinterpret_cast<bf16*>(smem + slot * S::kStage + S::kW);
  };

  // x rows past M stay zero in every slot; the copies below skip them.
  for (int i = tid; i < S::kStages * (S::kRows - M) * 4; i += kThreads) {
    const int slot = i / ((S::kRows - M) * 4);
    const int r = i % ((S::kRows - M) * 4);
    *reinterpret_cast<uint4*>(ring_x(slot) + (M + r / 4) * S::kXP
                              + (r % 4) * 8) = make_uint4(0, 0, 0, 0);
  }

  // Stage `st` of this split into ring slot `slot`: 32 code rows of the
  // column tile and the x columns they multiply.
  auto load = [&](int st, int slot) {
    const int k0 = k_begin + st * kStageRows;
    unsigned char* ws = ring_w(slot);
    constexpr int kWC = S::kBN / 16;  // 16-byte chunks per code row
#pragma unroll
    for (int c = tid; c < kStageRows * kWC; c += kThreads) {
      const int r = c / kWC;
      const int n = n0 + (c % kWC) * 16;
      const bool ok = n < N;
      cp_async16(smem_addr(ws + r * S::kWP + (c % kWC) * 16),
                 ok ? w + (int64_t)(k0 + r) * N + n : w, ok);
    }
    bf16* xs = ring_x(slot);
    for (int c = tid; c < M * 4; c += kThreads) {
      const int m = c >> 2;
      const int j = c & 3;
      cp_async16(smem_addr(xs + m * S::kXP + 8 * j),
                 x + (int64_t)m * K + k0 + 8 * j, true);
    }
  };

  float acc[MF][4][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < S::kStages - 1; ++st) {
    if (st < n_it) load(st, st);
    cp_async_commit();
  }

  const int col = wn * 32 + 4 * g;  // this thread's 4 code columns
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<S::kStages - 2>();
    __syncthreads();  // stage `it` landed; slot (it - 1) % kStages is free
    const int nxt = it + S::kStages - 1;
    if (nxt < n_it) load(nxt, nxt % S::kStages);
    cp_async_commit();

    const int slot = it % S::kStages;
    const unsigned char* ws = ring_w(slot);
    const bf16* xs = ring_x(slot);
#pragma unroll
    for (int kh = 0; kh < kStageRows / 16; ++kh) {
      const int r0 = kh * 16;
      // code rows r0 + 2t, 2t + 1, 2t + 8, 2t + 9 of 4 columns: ~2.75
      // instructions a code (dq::q8_f32x4, then one prmt a pair)
      float f[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + 2 * t + (q & 1) + (q >> 1) * 8;
        dq::q8_f32x4(*reinterpret_cast<const uint32_t*>(ws + r * S::kWP
                                                        + col), f[q]);
      }
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = dq::int_f32_bf16x2(f[0][j], f[1][j]);
        b[j][1] = dq::int_f32_bf16x2(f[2][j], f[3][j]);
      }
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(xs + (mf * 16 + (lane & 15)) * S::kXP + r0
                                 + (lane >> 4) * 8));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mf][j], a, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue from the accumulators: fragment j's column g is code column
  // 4g + j, so lane (g, t) holds columns 8t .. 8t + 7 of its warp's 32 (c0
  // of fragment j at 8t + j, c1 at 8t + 4 + j) for rows g and g + 8 of each
  // 16-row fragment: one 16-byte bf16 store, or two f32 ones, a row.
  const int n = n0 + wn * 32 + 8 * t;
  if (n >= N) return;
  float sc[8];
  if (part == nullptr) {
    const float4 s0 = *reinterpret_cast<const float4*>(s + n);
    const float4 s1 = *reinterpret_cast<const float4*>(s + n + 4);
    sc[0] = s0.x; sc[1] = s0.y; sc[2] = s0.z; sc[3] = s0.w;
    sc[4] = s1.x; sc[5] = s1.y; sc[6] = s1.z; sc[7] = s1.w;
  }
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mf * 16 + g + 8 * h;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mf][j][2 * h];
        v[4 + j] = acc[mf][j][2 * h + 1];
      }
      if (part == nullptr) {
        uint4 o;
        o.x = pack_bf16x2(v[0] * sc[0], v[1] * sc[1]);
        o.y = pack_bf16x2(v[2] * sc[2], v[3] * sc[3]);
        o.z = pack_bf16x2(v[4] * sc[4], v[5] * sc[5]);
        o.w = pack_bf16x2(v[6] * sc[6], v[7] * sc[7]);
        *reinterpret_cast<uint4*>(out + (int64_t)m * N + n) = o;
      } else {
        float4* dst = reinterpret_cast<float4*>(
            part + ((int64_t)split * M + m) * N + n);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
}

// ---- the split reduction -----------------------------------------------------

// out = bf16(sum over s of part[s] [* scale[column]]) in split order; part
// [n_split, M, N] f32 (N a multiple of 4); scale [N] f32 (q8) or null (q4).
__global__ void __launch_bounds__(256)
reduce_splits(const float* __restrict__ part, const float* __restrict__ scale,
              bf16* __restrict__ out, int64_t mn, int n, int n_split) {
  const int64_t n4 = mn / 4;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    float4 a = reinterpret_cast<const float4*>(part)[i];
    for (int sp = 1; sp < n_split; ++sp) {
      const float4 b = reinterpret_cast<const float4*>(part + sp * mn)[i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    if (scale != nullptr) {
      const float4 c =
          *reinterpret_cast<const float4*>(scale + (4 * i) % n);
      a.x *= c.x;
      a.y *= c.y;
      a.z *= c.z;
      a.w *= c.w;
    }
    uint2 o;
    o.x = pack_bf16x2(a.x, a.y);
    o.y = pack_bf16x2(a.z, a.w);
    reinterpret_cast<uint2*>(out)[i] = o;
  }
}

// The reduction after a split GEMM on `st` (nothing with one split).
inline int launch_reduce(float* part, const float* scale, void* out, int M,
                         int N, int n_split, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const int64_t mn = (int64_t)M * N;
  const int64_t blocks = (mn / 4 + 255) / 256;
  reduce_splits<<<(int)(blocks < 1056 ? blocks : 1056), 256, 0, st>>>(
      part, scale, static_cast<bf16*>(out), mn, N, n_split);
  return (int)cudaGetLastError();
}

template <int MODE, int MF, int WN>
int launch_small(const void* x, const void* w, const float* s, const float* z,
                 void* out, float* part, int M, int N, int K, int group,
                 int half, int n_split, int span, cudaStream_t st) {
  using S = Shape<MF, WN>;
  // Opt in to the instantiation's shared memory once.
  static const cudaError_t attr = cudaFuncSetAttribute(
      q4_small_m<MODE, MF, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + S::kBN - 1) / S::kBN, n_split);
  q4_small_m<MODE, MF, WN><<<grid, S::kThreads, S::kSmem, st>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(w), s, z,
      static_cast<bf16*>(out), n_split > 1 ? part : nullptr, M, N, K, group,
      half, span);
  return launch_reduce(part, nullptr, out, M, N, n_split, st);
}

template <int MF, int WN>
int launch_small_q8(const void* x, const void* w, const float* s, void* out,
                    float* part, int M, int N, int K, int n_split, int span,
                    cudaStream_t st) {
  using S = Q8Shape<MF, WN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      q8_small_m<MF, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + S::kBN - 1) / S::kBN, n_split);
  q8_small_m<MF, WN><<<grid, S::kThreads, S::kSmem, st>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w), s,
      static_cast<bf16*>(out), n_split > 1 ? part : nullptr, M, N, K, span);
  return launch_reduce(part, s, out, M, N, n_split, st);
}

}  // namespace dqs
