// Paged flash decode for Hopper: one templated body behind four entry
// points, over a bf16 pool or an int8 pool with one bf16 scale per token.
//
// Replaces, in dynamo_tpu/ops/paged_attention.py:
//   paged_decode_pool_bf16     _pool_decode_kernel (paged_decode_attention_pool),
//                              bf16 branch: partials over the whole pool at
//                              `layer`
//   paged_decode_pool_int8     the same kernel's `quantized=True` branch
//   paged_decode_bf16          _decode_kernel (paged_decode_attention):
//                              NORMALIZED output over one layer's K and V
//                              slices, lengths including the current token
//   paged_decode_partial_bf16  _decode_kernel_partial
//                              (paged_decode_attention_partial): partials
//                              over one layer's slices, history lengths
// For every (sequence b, kv head h) the body runs an online softmax over
// the GQA group of g = qh / kh query rows against positions < lens[b],
// reading only the ceil(lens[b] / ps) pages the block table owns (never
// scratch page 0). The partial entry points write UNNORMALIZED partials
//   acc[b, h, gi, :] = sum_t exp(s_t - m) * v_t   (f32)
//   m[b, h, gi], l[b, h, gi] = running max and sum of exp(s_t - m)
// with zero-length rows written as acc = 0, m = -inf, l = 0; the
// normalized one writes acc / l in bf16, 0 for a zero-length row.
//
// K and V are read in place: the kernel takes a K base and a V base plus
// the page and token strides, so a layer slice kv_cache[layer, 0] is a
// strided view, never a .contiguous() copy. A speculative verification
// step folds its chunk of T positions into the group (g' = T * g rows that
// share one history); any g' runs, in tiles of 16 or 32 rows.
//
// The int8 pool stores K/V as int8 codes [L, 2, P, ps, kh, hd] and one bf16
// scale per token shared by the kv heads, [L, 2, P, ps]. Codes convert to
// bf16 exactly (|code| <= 127); the score is (q . k_codes) * k_scale, and
// each probability is multiplied by the token's v_scale before P.V.
//
// Bound on this card: HBM bytes. Each history token's K and V rows (2 * hd
// values per kv head, 2 bytes each in bf16, 1 in int8) are read once per
// row tile; the arithmetic, 4 * g * hd flops per token, is ~1/60 of the
// bf16 tensor-core time for those bytes even at the folded width. At
// llama3-8b decode shapes (B = 8, 4,596 history tokens) the bytes bound is
// 5.7 us (bf16) and 2.9 us (int8) at the H100 SXM's 3.35 TB/s. Measured by
// chip_smoke.py's kernels phase on an NVIDIA H100 80GB HBM3 at 700.00 W:
// 0.024-0.025 ms at those shapes (4.2x the bf16 bound, 8.6x the int8
// one), 0.029-0.031 ms folded to g' = 20 rows, 0.044-0.046 ms at g' = 40;
// see PERF.md section 6.
//
// Design (flash-decoding with tensor cores):
//   1. Split-KV. The grid is (n_split, kh * row_tiles, B): each block takes
//      one span of `span` history tokens (a multiple of the 64-token tile
//      and of ps) of one (sequence, kv head, row tile). The span is chosen
//      on the host from shapes only (B, kh, rows, max_pages; never lens),
//      so that a short batch still fills the 132 SMs. With one split the
//      block writes the outputs itself; with several, live blocks write
//      f32 partials to scratch, blocks past lens[b] exit, and merge_kernel
//      rescales the live splits into (acc, m, l) or acc / l; a row with no
//      live split becomes exactly acc = 0, m = -inf, l = 0.
//   2. A cp.async page ring. A tile is 64 tokens of K and V; kStages tiles
//      are in flight in shared memory, each token row gathered through the
//      block table with 16-byte cp.async.cg copies (zero-filled past the
//      history). Rows are padded by 16 bytes so ldmatrix reads them without
//      bank conflicts. The int8 ring converts each arrived tile to bf16 in
//      shared memory once, then runs the bf16 path.
//   3. q.k and p.v on the tensor cores: mma.sync m16n8k16 bf16 -> f32 with
//      ldmatrix (K, Q) and ldmatrix.trans (V) operands. Query rows are the
//      M dimension (16 a tile), tokens N (q.k) and K (p.v). Each of the 4
//      warps takes 16 tokens of a tile with its own online softmax in
//      registers; the warps merge at the end. P is split into bf16 parts
//      (hi + lo, and a third for the normalized entry point) and p.v runs
//      once per part, so rounding P to bf16 costs no accuracy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // tokens per ring stage; 16 per warp
constexpr int kStages = 3;  // ring depth: kStages - 1 tiles in flight
constexpr int kMaxSpan = 2048;  // tokens per split (bounds the table copy)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <bool Q8>
using Val = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Two probabilities (columns k, k + 1 of one A-fragment row) as N bf16
// parts, largest first: x = sum of the parts to ~2^-(8N + 1) relative.
template <int N>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&parts)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
    parts[i] = pack_bf16(h0, h1);
    x0 -= __bfloat162float(h0);
    x1 -= __bfloat162float(h1);
  }
}

// ---- shared-memory layout ------------------------------------------------

// Row pitches in bytes: the data plus 16 bytes, so the 8 rows an ldmatrix
// phase reads fall in distinct bank groups.
template <int HD>
__host__ __device__ constexpr int bf16_pitch() { return HD * 2 + 16; }
template <int HD, bool Q8>
__host__ __device__ constexpr int ring_pitch() { return HD * static_cast<int>(sizeof(Val<Q8>)) + 16; }

template <int HD, bool Q8, int MT>
struct Layout {
  static constexpr int kRows = 16 * MT;  // query rows of a row tile
  static constexpr int kQ = kRows * bf16_pitch<HD>();
  static constexpr int kRing = kStages * 2 * kTile * ring_pitch<HD, Q8>();
  static constexpr int kScales = Q8 ? kStages * 2 * kTile * 2 : 0;
  static constexpr int kConv = Q8 ? 2 * kTile * bf16_pitch<HD>() : 0;
  static constexpr int kRed = kWarps * kRows * HD * 4;  // per-warp acc, epilogue
  static constexpr int kMain = (kRing + kScales + kConv) > kRed
                                   ? (kRing + kScales + kConv) : kRed;
  static constexpr int kStats = 2 * kWarps * kRows * 4;  // per-warp m and l
  // q | ring | scales | converted tile (the epilogue reuses all three) |
  // stats | table
  static constexpr int kFixed = kQ + kMain + kStats;
  static constexpr int kMax = kFixed + kMaxSpan * 4;
};

// ---- the body ------------------------------------------------------------

// One block: a span [split * span, +span) of sequence b's history against
// query rows [r0, r0 + 16 * MT) of kv head h's group. MT: 16-row m-tiles
// per row tile; kNorm: the normalized entry point (acc / l in bf16 to
// `out` when the block covers the whole history, n_split == 1).
// acc_out / m_out / l_out are the outputs themselves when n_split == 1,
// else the scratch partials [B, kh, n_split, g, HD] / [B, kh, n_split, g].
template <int HD, bool Q8, int MT, bool kNorm>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q,  // [B, kh * g, HD]
              const Val<Q8>* __restrict__ k_rows,   // K of one layer [P, ps, kh, HD]
              const Val<Q8>* __restrict__ v_rows,   // V, same strides
              const __nv_bfloat16* __restrict__ k_scales,  // [P, ps] (Q8)
              const __nv_bfloat16* __restrict__ v_scales,  // [P, ps] (Q8)
              const int32_t* __restrict__ tables,   // [B, max_pages]
              const int32_t* __restrict__ lens,     // [B] tokens to attend
              float* __restrict__ acc_out,
              float* __restrict__ m_out,
              float* __restrict__ l_out,
              __nv_bfloat16* __restrict__ out,      // [B, kh * g, HD] (kNorm)
              int kh, int g, int ps, int max_pages, int n_split, int span,
              int64_t s_page, int64_t s_tok, float scale) {
  static_assert(HD == 64 || HD == 128, "HD must be 64 or 128");
  using L = Layout<HD, Q8, MT>;
  using T = Val<Q8>;
  constexpr int kRows = L::kRows;
  constexpr int kKS = HD / 16;  // k-steps of q.k
  constexpr int kDN = HD / 8;   // 8-wide head-dim tiles of p.v
  constexpr int kQP = bf16_pitch<HD>();
  constexpr int kRP = ring_pitch<HD, Q8>();
  constexpr int kChunks = HD * static_cast<int>(sizeof(T)) / 16;  // copies per row
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));  // values per copy
  // bf16 parts of P in p.v: hi + lo keeps the f32 partials within ~1e-5 of
  // the plain version; the normalized entry point rounds its output to
  // bf16, so a third part keeps its sum as close to f32 as the plain
  // version's and the two round alike.
  constexpr int kParts = kNorm ? 3 : 2;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* ring = smem + L::kQ;
  __nv_bfloat16* sc_s = reinterpret_cast<__nv_bfloat16*>(ring + L::kRing);
  unsigned char* conv = ring + L::kRing + L::kScales;
  float* red_s = reinterpret_cast<float*>(ring);  // epilogue only
  float* m_red = reinterpret_cast<float*>(ring + L::kMain);
  float* l_red = m_red + kWarps * kRows;
  int32_t* tab_s = reinterpret_cast<int32_t*>(l_red + kWarps * kRows);

  const int split = blockIdx.x;
  const int row_tiles = (g + kRows - 1) / kRows;
  const int h = blockIdx.y / row_tiles;
  const int r0 = (blockIdx.y % row_tiles) * kRows;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tq = lane & 3;

  int len = lens[b];
  const int n_pages = len > 0 ? min((len + ps - 1) / ps, max_pages) : 0;
  len = min(len, n_pages * ps);
  const int start = split * span;  // a multiple of ps
  const int end = min(start + span, len);
  if (n_split > 1 && start >= end) return;  // the merge reads live splits only

  // The row tile's queries (zero rows past g) and the span's table entries.
  const __nv_bfloat16* qb = q + ((int64_t)b * kh * g + (int64_t)h * g + r0) * HD;
  for (int i = tid; i < kRows * (HD / 8); i += kThreads) {
    const int r = i / (HD / 8), c = i % (HD / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < g) v = *reinterpret_cast<const uint4*>(qb + (int64_t)r * HD + c * 8);
    *reinterpret_cast<uint4*>(q_s + r * kQP + c * 16) = v;
  }
  const int n_tab = end > start ? (end - start + ps - 1) / ps : 0;
  const int32_t* table = tables + (int64_t)b * max_pages + start / ps;
  for (int i = tid; i < n_tab; i += kThreads) tab_s[i] = table[i];
  __syncthreads();

  const T* k_head = k_rows + (int64_t)h * HD;
  const T* v_head = v_rows + (int64_t)h * HD;
  const int n_tiles = end > start ? (end - start + kTile - 1) / kTile : 0;

  // Gather tile `it` into its ring stage: one 16-byte copy per chunk of a
  // token row, K rows then V rows; positions past the span are zero-filled.
  auto load_tile = [&](int it) {
    const int stage = it % kStages;
    const int t0 = start + it * kTile;
    unsigned char* st = ring + stage * 2 * kTile * kRP;
    for (int i = tid; i < 2 * kTile * kChunks; i += kThreads) {
      const int kv = i / (kTile * kChunks);
      const int row = (i / kChunks) % kTile;
      const int c = i % kChunks;
      const int pos = t0 + row;
      const bool valid = pos < end;
      const T* src = kv ? v_head : k_head;
      if (valid) {
        const int rel = pos - start;
        src += (int64_t)tab_s[rel / ps] * s_page + (int64_t)(rel % ps) * s_tok + c * kElems;
      }
      cp_async16(smem_addr(st + (kv * kTile + row) * kRP + c * 16), src, valid);
    }
    if constexpr (Q8) {
      // Scales of token pairs: ps is even and tiles start on even
      // positions, so a pair never straddles a page.
      for (int i = tid; i < kTile; i += kThreads) {
        const int kv = i / (kTile / 2);
        const int pair = i % (kTile / 2);
        const int pos = t0 + 2 * pair;
        const bool valid = pos < end;
        const __nv_bfloat16* src = kv ? v_scales : k_scales;
        if (valid) {
          const int rel = pos - start;
          src += (int64_t)tab_s[rel / ps] * ps + rel % ps;
        }
        cp_async4(smem_addr(sc_s + (stage * 2 + kv) * kTile + 2 * pair), src, valid);
      }
    }
  };

  float o[MT][kDN][4];
  float m[MT][2], l[MT][2];  // per thread rows gid and gid + 8; m in log2 units
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int dn = 0; dn < kDN; ++dn)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[mt][dn][j] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }
  const float qk_scale = scale * kLog2e;
  const int tw = warp * 16;  // the warp's tokens within a tile

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` landed; the stage refilled below is free
    if (it + kStages - 1 < n_tiles) load_tile(it + kStages - 1);
    cp_async_commit();
    const int stage = it % kStages;
    const unsigned char* k_tile = ring + stage * 2 * kTile * kRP;
    const unsigned char* v_tile = k_tile + kTile * kRP;
    if constexpr (Q8) {
      // int8 codes -> bf16 (exact), K and V rows of the tile
      for (int i = tid; i < 2 * kTile * (HD / 16); i += kThreads) {
        const int row = i / (HD / 16), c = i % (HD / 16);
        const uint4 raw = *reinterpret_cast<const uint4*>(k_tile + row * kRP + c * 16);
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t cv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t bits = w[j / 2] >> (16 * (j % 2));
          cv[j] = pack_bf16(__float2bfloat16_rn((float)(int8_t)(bits & 0xFFu)),
                            __float2bfloat16_rn((float)(int8_t)((bits >> 8) & 0xFFu)));
        }
        uint4* dst = reinterpret_cast<uint4*>(conv + row * kQP + c * 32);
        dst[0] = make_uint4(cv[0], cv[1], cv[2], cv[3]);
        dst[1] = make_uint4(cv[4], cv[5], cv[6], cv[7]);
      }
      __syncthreads();
      k_tile = conv;
      v_tile = conv + kTile * kQP;
    }
    const int t0 = start + it * kTile + tw;

    // S = Q K^T for the warp's 16 tokens: rows in M, tokens in N.
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[mt][nt][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t kf[4];
      ldmatrix_x4(kf, smem_addr(k_tile + (tw + (lane & 7) + ((lane >> 4) << 3)) * kQP
                                + (ks * 16 + ((lane >> 3) & 1) * 8) * 2));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qf[4];
        ldmatrix_x4(qf, smem_addr(q_s + (mt * 16 + (lane & 15)) * kQP
                                  + (ks * 16 + (lane >> 4) * 8) * 2));
        mma_bf16(s[mt][0], qf, kf[0], kf[1]);
        mma_bf16(s[mt][1], qf, kf[2], kf[3]);
      }
    }

    // Scale (and int8 k_scale), mask past the span; accumulator j holds
    // row gid + 8 * (j / 2), token nt * 8 + 2 * tq + j % 2.
    float vsc[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = nt * 8 + 2 * tq + jj;
        float ksc = qk_scale;
        vsc[nt][jj] = 1.f;
        if constexpr (Q8) {
          ksc *= __bfloat162float(sc_s[(stage * 2) * kTile + tw + col]);
          vsc[nt][jj] = __bfloat162float(sc_s[(stage * 2 + 1) * kTile + tw + col]);
        }
        const bool valid = t0 + col < end;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          s[mt][nt][jj] = valid ? s[mt][nt][jj] * ksc : -INFINITY;
          s[mt][nt][2 + jj] = valid ? s[mt][nt][2 + jj] * ksc : -INFINITY;
        }
      }
    }

    // Online softmax per row: the 4 lanes of a row hold its 16 tokens.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = fmaxf(fmaxf(s[mt][0][2 * hr], s[mt][0][2 * hr + 1]),
                         fmaxf(s[mt][1][2 * hr], s[mt][1][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][hr], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[mt][hr] - m_use);  // 0 while nothing was seen
        m[mt][hr] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const float p = exp2f(s[mt][nt][2 * hr + jj] - m_use);  // 0 when masked
            sum += p;
            s[mt][nt][2 * hr + jj] = p * vsc[nt][jj];
          }
        }
        l[mt][hr] = l[mt][hr] * alpha + sum;  // this lane's share of the row
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          o[mt][dn][2 * hr] *= alpha;
          o[mt][dn][2 * hr + 1] *= alpha;
        }
      }
    }

    // O += P V: P from the score accumulators as the A operand, in kParts
    // bf16 parts; V through ldmatrix.trans as B. A-fragment register j
    // holds row gid + 8 * (j % 2), tokens 8 * (j / 2) + 2 * tq and + 1.
    uint32_t pf[kParts][MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t parts[kParts];
        split_pair<kParts>(s[mt][j >> 1][(j & 1) * 2], s[mt][j >> 1][(j & 1) * 2 + 1], parts);
#pragma unroll
        for (int i = 0; i < kParts; ++i) pf[i][mt][j] = parts[i];
      }
    }
#pragma unroll
    for (int dn = 0; dn < kDN; dn += 2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, smem_addr(v_tile + (tw + (lane & 7) + ((lane >> 3) & 1) * 8) * kQP
                                      + (dn * 8 + (lane >> 4) * 8) * 2));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < kParts; ++i) {
          mma_bf16(o[mt][dn], pf[i][mt], vf[0], vf[1]);
          mma_bf16(o[mt][dn + 1], pf[i][mt], vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is reused below

  // Merge the 4 warps' partials in shared memory, then write. Every output
  // row of the tile is written, zero-length rows included (m = -inf).
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[mt][hr] += __shfl_xor_sync(0xffffffffu, l[mt][hr], 1);
      l[mt][hr] += __shfl_xor_sync(0xffffffffu, l[mt][hr], 2);
      if (tq == 0) m_red[warp * kRows + mt * 16 + hr * 8 + gid] = m[mt][hr];
    }
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = mt * 16 + hr * 8 + gid;
      float ms = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) ms = fmaxf(ms, m_red[w * kRows + row]);
      const float f = ms == -INFINITY ? 0.f : exp2f(m[mt][hr] - ms);
      float* dst = red_s + (warp * kRows + row) * HD + 2 * tq;
#pragma unroll
      for (int dn = 0; dn < kDN; ++dn) {
        *reinterpret_cast<float2*>(dst + dn * 8) =
            make_float2(o[mt][dn][2 * hr] * f, o[mt][dn][2 * hr + 1] * f);
      }
      if (tq == 0) l_red[warp * kRows + row] = l[mt][hr] * f;
    }
  }
  __syncthreads();
  const int64_t bh = (int64_t)b * kh + h;
  const bool normalize = kNorm && n_split == 1;
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int row = i / HD;
    if (r0 + row >= g) break;  // rows ascend with i
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red_s[w * kRows * HD + i];
    if (normalize) {
      float lsum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) lsum += l_red[w * kRows + row];
      out[(bh * g + r0) * HD + i] = __float2bfloat16(lsum > 0.f ? sum / lsum : 0.f);
    } else {
      acc_out[((bh * n_split + split) * g + r0) * HD + i] = sum;
    }
  }
  if (!normalize) {
    for (int row = tid; row < kRows && r0 + row < g; row += kThreads) {
      float ms = -INFINITY, lsum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        ms = fmaxf(ms, m_red[w * kRows + row]);
        lsum += l_red[w * kRows + row];
      }
      const int64_t o_row = (bh * n_split + split) * g + r0 + row;
      m_out[o_row] = ms * kLn2;  // natural units; -inf stays -inf
      l_out[o_row] = lsum;
    }
  }
}

// The splits' partials of one output row -> (acc, m, l), or acc / l in
// bf16 (kNorm). Grid (g, kh, B), one thread per head dim. Only the live
// splits (those starting below the history length) are read; a row with
// none is acc = 0, m = -inf, l = 0 (kNorm: 0).
template <int HD, bool kNorm>
__global__ void __launch_bounds__(HD)
merge_kernel(const float* __restrict__ part_acc,  // [B, kh, n_split, g, HD]
             const float* __restrict__ part_m,    // [B, kh, n_split, g]
             const float* __restrict__ part_l,
             const int32_t* __restrict__ lens,
             float* __restrict__ acc_out, float* __restrict__ m_out,
             float* __restrict__ l_out, __nv_bfloat16* __restrict__ out,
             int kh, int g, int ps, int max_pages, int n_split, int span) {
  const int row = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  int len = lens[b];
  const int n_pages = len > 0 ? min((len + ps - 1) / ps, max_pages) : 0;
  len = min(len, n_pages * ps);
  const int live = len > 0 ? min((len + span - 1) / span, n_split) : 0;
  const int64_t bh = (int64_t)b * kh + h;
  const int64_t first = bh * n_split * g + row;  // split 0's partial row
  float ms = -INFINITY;
  for (int s = 0; s < live; ++s) ms = fmaxf(ms, part_m[first + (int64_t)s * g]);
  float acc = 0.f, lsum = 0.f;
  if (ms != -INFINITY) {
    for (int s = 0; s < live; ++s) {
      const int64_t r = first + (int64_t)s * g;
      const float w = expf(part_m[r] - ms);
      acc += w * part_acc[r * HD + d];
      lsum += w * part_l[r];
    }
  }
  const int64_t o_row = bh * g + row;
  if constexpr (kNorm) {
    out[o_row * HD + d] = __float2bfloat16(lsum > 0.f ? acc / lsum : 0.f);
  } else {
    acc_out[o_row * HD + d] = acc;
    if (d == 0) {
      m_out[o_row] = ms;
      l_out[o_row] = lsum;
    }
  }
}

// Everything one launch needs; K/V bases already point at the layer (and
// at K or V), strides are in elements.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* k_scales;
  const void* v_scales;
  const void* tables;
  const void* lens;
  void* acc;
  void* m;
  void* l;
  void* out;
  void* part_acc;
  void* part_m;
  void* part_l;
  int batch, kh, g, hd, ps, max_pages, n_split, span;
  long long s_page, s_tok;
  float scale;
};

template <int HD, bool Q8, int MT, bool kNorm>
int launch_one(const Args& a, cudaStream_t st) {
  using L = Layout<HD, Q8, MT>;
  // Opt in to the instantiation's largest shared-memory size once.
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<HD, Q8, MT, kNorm>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kMax);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = L::kFixed + sizeof(int32_t) * (size_t)(a.span / a.ps);
  const int row_tiles = (a.g + L::kRows - 1) / L::kRows;
  const bool direct = a.n_split == 1;
  decode_kernel<HD, Q8, MT, kNorm><<<dim3(a.n_split, a.kh * row_tiles, a.batch),
                                     kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const Val<Q8>*>(a.k),
      static_cast<const Val<Q8>*>(a.v), static_cast<const __nv_bfloat16*>(a.k_scales),
      static_cast<const __nv_bfloat16*>(a.v_scales), static_cast<const int32_t*>(a.tables),
      static_cast<const int32_t*>(a.lens),
      static_cast<float*>(direct ? a.acc : a.part_acc),
      static_cast<float*>(direct ? a.m : a.part_m),
      static_cast<float*>(direct ? a.l : a.part_l),
      static_cast<__nv_bfloat16*>(a.out), a.kh, a.g, a.ps, a.max_pages,
      a.n_split, a.span, a.s_page, a.s_tok, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  merge_kernel<HD, kNorm><<<dim3(a.g, a.kh, a.batch), HD, 0, st>>>(
      static_cast<const float*>(a.part_acc), static_cast<const float*>(a.part_m),
      static_cast<const float*>(a.part_l), static_cast<const int32_t*>(a.lens),
      static_cast<float*>(a.acc), static_cast<float*>(a.m), static_cast<float*>(a.l),
      static_cast<__nv_bfloat16*>(a.out), a.kh, a.g, a.ps, a.max_pages, a.n_split,
      a.span);
  return (int)cudaGetLastError();
}

// Row tiles of 16 rows for an unfolded group, 32 for a folded chunk.
template <int HD, bool Q8, bool kNorm>
int launch_hd(const Args& a, cudaStream_t st) {
  if (a.g <= 16) return launch_one<HD, Q8, 1, kNorm>(a, st);
  return launch_one<HD, Q8, 2, kNorm>(a, st);
}

template <bool Q8, bool kNorm>
int launch(const Args& a, void* stream) {
  // The host's split plan: spans of whole tiles and pages that cover the
  // table, at most kMaxSpan tokens; scratch present when there are splits.
  if (a.batch <= 0 || a.kh <= 0 || a.g <= 0 || a.ps <= 0 || a.max_pages <= 0
      || a.n_split <= 0 || a.span <= 0 || a.span > kMaxSpan || a.span % kTile != 0
      || a.span % a.ps != 0 || (long long)a.n_split * a.span < (long long)a.max_pages * a.ps
      || (Q8 && a.ps % 2 != 0)
      || (a.n_split > 1 && (!a.part_acc || !a.part_m || !a.part_l))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (a.hd == 128) return launch_hd<128, Q8, kNorm>(a, st);
  if (a.hd == 64) return launch_hd<64, Q8, kNorm>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// All launch on `stream` and return cudaGetLastError() (0 = launched).
// Strides are in elements. For the pool entry points `layer_off` already
// includes layer * stride(0) and `s_kv` is stride(1); for the int8 pool
// `sc_layer_off` and `sc_kv` index the contiguous [L, 2, P, ps] scales the
// same way. The one-layer entry points take K and V slices [P, ps, kh, hd]
// with equal page and token strides and contiguous (kh, hd) rows.
// `n_split` and `span` are the host's split plan; with n_split > 1 the
// part_* scratch ([B, kh, n_split, g, hd] and [B, kh, n_split, g] f32)
// holds the splits' partials and a second kernel merges them.
extern "C" int paged_decode_pool_bf16(
    const void* q, const void* pool, const void* tables, const void* lens,
    void* acc, void* m, void* l, void* part_acc, void* part_m, void* part_l,
    int batch, int kh, int g, int hd, int ps, int max_pages, int n_split, int span,
    long long layer_off, long long s_kv, long long s_page, long long s_tok,
    float scale, void* stream) {
  const auto* k = static_cast<const __nv_bfloat16*>(pool) + layer_off;
  return launch<false, false>(
      Args{q, k, k + s_kv, nullptr, nullptr, tables, lens, acc, m, l, nullptr,
           part_acc, part_m, part_l, batch, kh, g, hd, ps, max_pages, n_split, span,
           s_page, s_tok, scale},
      stream);
}

extern "C" int paged_decode_pool_int8(
    const void* q, const void* pool, const void* scales, const void* tables,
    const void* lens, void* acc, void* m, void* l, void* part_acc, void* part_m,
    void* part_l, int batch, int kh, int g, int hd, int ps, int max_pages,
    int n_split, int span, long long layer_off, long long s_kv, long long s_page,
    long long s_tok, long long sc_layer_off, long long sc_kv, float scale,
    void* stream) {
  const auto* k = static_cast<const int8_t*>(pool) + layer_off;
  const auto* ks = static_cast<const __nv_bfloat16*>(scales) + sc_layer_off;
  return launch<true, false>(
      Args{q, k, k + s_kv, ks, ks + sc_kv, tables, lens, acc, m, l, nullptr,
           part_acc, part_m, part_l, batch, kh, g, hd, ps, max_pages, n_split, span,
           s_page, s_tok, scale},
      stream);
}

extern "C" int paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lens, void* out, void* part_acc,
    void* part_m, void* part_l, int batch, int kh, int g, int hd, int ps,
    int max_pages, int n_split, int span, long long s_page, long long s_tok,
    float scale, void* stream) {
  return launch<false, true>(
      Args{q, k_pages, v_pages, nullptr, nullptr, tables, lens, nullptr,
           nullptr, nullptr, out, part_acc, part_m, part_l, batch, kh, g, hd, ps,
           max_pages, n_split, span, s_page, s_tok, scale},
      stream);
}

extern "C" int paged_decode_partial_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lens, void* acc, void* m, void* l,
    void* part_acc, void* part_m, void* part_l, int batch, int kh, int g,
    int hd, int ps, int max_pages, int n_split, int span, long long s_page,
    long long s_tok, float scale, void* stream) {
  return launch<false, false>(
      Args{q, k_pages, v_pages, nullptr, nullptr, tables, lens, acc, m, l,
           nullptr, part_acc, part_m, part_l, batch, kh, g, hd, ps, max_pages,
           n_split, span, s_page, s_tok, scale},
      stream);
}
