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
// reading only the pages the block table owns. The partial entry points
// write UNNORMALIZED partials
//   acc[b, h, gi, :] = sum_t exp(s_t - m) * v_t   (f32)
//   m[b, h, gi], l[b, h, gi] = running max and sum of exp(s_t - m)
// with zero-length rows written as acc = 0, m = -inf, l = 0; the
// normalized one writes acc / l in bf16, 0 for a zero-length row.
//
// The whole-pool and one-layer entry points differ only in where K and V
// start: the kernel takes a K base and a V base plus the page and token
// strides, so a layer slice kv_cache[layer, 0] is read in place (a strided
// view, never a .contiguous() copy of the layer).
//
// A speculative verification step folds its chunk of T positions into the
// GQA group (g' = T * g rows that share one history), so g * hd reaches
// (DYNT_SPEC_MAX_K + 1) * 4 * 128 = 2560 at llama3-8b's defaults. Wider
// groups take a second instantiation with more accumulator rows; a group
// beyond kMaxGroupDim is refused (the wrapper raises before it launches).
//
// The int8 pool stores K/V as int8 codes [L, 2, P, ps, kh, hd] and one bf16
// scale per token shared by all kv heads, [L, 2, P, ps]. It dequantizes in
// the loop: the score is (q . k_codes) * k_scale, and each probability is
// multiplied by the token's v_scale before the P.V accumulation, so a code
// row is read once and never widened in memory.
//
// Bound on this card: HBM bytes. Each history token's K and V rows (2 * hd
// values per kv head, 2 bytes each in bf16, 1 in int8) are read once and
// reused by all g query rows; the arithmetic is 4 * g * hd flops per
// token, far below the bytes' time even at the folded width.
//
// Design (simple and right first): grid (B, kh), one block of 128 threads
// per (sequence, kv head). The block walks the history 128 tokens (8 pages
// of 16) per iteration, like the JAX kernel's page chunks:
//   1. scores: one token per thread; the thread resolves its page through
//      the block table and reads the token's whole K row in 8-value loads,
//      dotting it with the g query rows held in shared memory;
//   2. online softmax: one warp per query row (warp w takes rows w, w + 4,
//      ...) updates the running max and sum over the chunk and turns the
//      scores into probabilities;
//   3. P.V: warp w takes tokens 32w..32w+31 of the chunk, each lane a slice
//      of the head dim, so every V element is read once; the warps' partial
//      sums are added in shared memory at the end.
// What it leaves on the table, for later work: at B = 8 the grid holds only
// B * kh = 64 blocks for 132 SMs and one block walks a long history alone
// (split-K over pages would fill the card); chunk loads are synchronous (no
// cp.async / TMA double buffering); the q.k and p.v products run on CUDA
// cores, not tensor cores (packing the GQA group into an mma tile would).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;  // history tokens per iteration
constexpr int kGroupDim = 1024;  // g * hd of an unfolded GQA group
constexpr int kMaxGroupDim = 3072;  // largest g * hd (a folded spec chunk)
constexpr size_t kDefaultSmem = 48 * 1024;  // beyond it: opt in per kernel

template <bool Q8>
using Val = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void bf16x2_to_float(uint32_t bits, float* out) {
  __nv_bfloat162 pair;
  memcpy(&pair, &bits, sizeof(pair));
  const float2 f = __bfloat1622float2(pair);
  out[0] = f.x;
  out[1] = f.y;
}

__device__ __forceinline__ float int8_to_float(uint32_t bits, int i) {
  return (float)(int8_t)((bits >> (8 * i)) & 0xFFu);
}

// Eight consecutive values of a K row as floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  bf16x2_to_float(raw.x, out);
  bf16x2_to_float(raw.y, out + 2);
  bf16x2_to_float(raw.z, out + 4);
  bf16x2_to_float(raw.w, out + 6);
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = int8_to_float(raw.x, i);
    out[4 + i] = int8_to_float(raw.y, i);
  }
}

// A lane's kE consecutive V values (kE = hd / 32: 4 or 2) as floats.
template <int kE>
__device__ __forceinline__ void load_lane(const __nv_bfloat16* p, float* out) {
  if constexpr (kE == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    bf16x2_to_float(raw.x, out);
    bf16x2_to_float(raw.y, out + 2);
  } else {
    bf16x2_to_float(*reinterpret_cast<const uint32_t*>(p), out);
  }
}

template <int kE>
__device__ __forceinline__ void load_lane(const int8_t* p, float* out) {
  if constexpr (kE == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = int8_to_float(raw, i);
  } else {
    const uint32_t raw = *reinterpret_cast<const uint16_t*>(p);
    out[0] = int8_to_float(raw, 0);
    out[1] = int8_to_float(raw, 1);
  }
}

size_t smem_bytes(int g, int hd, bool quantized) {
  return sizeof(int64_t) * kChunk
         + sizeof(float) * ((size_t)g * hd * (1 + kWarps) + (size_t)g * kChunk + 3 * (size_t)g
                            + (quantized ? (size_t)kChunk : 0));
}

// kMaxG: the query rows the accumulators cover (g <= kMaxG); kNorm: write
// acc / l in bf16 to `out` instead of the partials.
template <int HD, bool Q8, int kMaxG, bool kNorm>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q,  // [B, kh * g, HD]
              const Val<Q8>* __restrict__ k_rows,   // K of one layer [P, ps, kh, HD]
              const Val<Q8>* __restrict__ v_rows,   // V, same strides
              const __nv_bfloat16* __restrict__ k_scales,  // [P, ps] (Q8)
              const __nv_bfloat16* __restrict__ v_scales,  // [P, ps] (Q8)
              const int32_t* __restrict__ tables,   // [B, max_pages]
              const int32_t* __restrict__ lens,     // [B] tokens to attend
              float* __restrict__ acc_out,          // [B, kh, g, HD] (partials)
              float* __restrict__ m_out,            // [B, kh, g]
              float* __restrict__ l_out,            // [B, kh, g]
              __nv_bfloat16* __restrict__ out,      // [B, kh * g, HD] (kNorm)
              int kh, int g, int ps, int max_pages,
              int64_t s_page, int64_t s_tok, float scale) {
  static_assert(HD == 64 || HD == 128, "HD must be 64 or 128");
  using T = Val<Q8>;
  constexpr int kLoads = HD / 8;               // 8-value loads per K row
  constexpr int kE = HD / 32;                  // head dims per lane in P.V

  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* off_s = reinterpret_cast<int64_t*>(smem);  // [kChunk] row offsets
  float* q_s = reinterpret_cast<float*>(off_s + kChunk);  // [g, HD]
  float* p_s = q_s + g * HD;                   // [g, kChunk] scores -> probs
  float* red_s = p_s + g * kChunk;             // [kWarps, g, HD] P.V partials
  float* m_s = red_s + kWarps * g * HD;        // [g] running max
  float* l_s = m_s + g;                        // [g] running sum
  float* a_s = l_s + g;                        // [g] rescale of the old acc
  float* vsc_s = a_s + g;                      // [kChunk] V scales (Q8)

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row0 = ((int64_t)b * kh + h) * g;  // output row of (b, h, 0)

  int len = lens[b];
  const int n_pages = len > 0 ? min((len + ps - 1) / ps, max_pages) : 0;
  len = min(len, n_pages * ps);

  float acc[kMaxG][kE];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[gi][e] = 0.f;

  if (len > 0) {
    const __nv_bfloat16* qb = q + row0 * HD;
    for (int i = tid; i < g * HD; i += kThreads) q_s[i] = __bfloat162float(qb[i]);
    for (int gi = tid; gi < g; gi += kThreads) {
      m_s[gi] = -INFINITY;
      l_s[gi] = 0.f;
    }
    __syncthreads();

    const T* k_head = k_rows + (int64_t)h * HD;
    const T* v_head = v_rows + (int64_t)h * HD;
    const int32_t* table = tables + (int64_t)b * max_pages;
    for (int c0 = 0; c0 < len; c0 += kChunk) {
      const int n = min(kChunk, len - c0);

      // 1. Scores: thread t scores history token c0 + t.
      if (tid < n) {
        const int pos = c0 + tid;
        const int32_t page = table[pos / ps];
        const int off_tok = pos % ps;
        const int64_t off = (int64_t)page * s_page + (int64_t)off_tok * s_tok;
        off_s[tid] = off;
        const T* kr = k_head + off;
        float s[kMaxG];
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) s[gi] = 0.f;
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          float kf[8];
          load8(kr + j * 8, kf);
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi) {
            if (gi < g) {
              const float4* qv = reinterpret_cast<const float4*>(q_s + gi * HD + j * 8);
              const float4 a = qv[0], c = qv[1];
              s[gi] += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3]
                       + c.x * kf[4] + c.y * kf[5] + c.z * kf[6] + c.w * kf[7];
            }
          }
        }
        float k_scale = scale;
        if constexpr (Q8) {
          const int64_t soff = (int64_t)page * ps + off_tok;
          k_scale *= __bfloat162float(k_scales[soff]);
          vsc_s[tid] = __bfloat162float(v_scales[soff]);
        }
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi)
          if (gi < g) p_s[gi * kChunk + tid] = s[gi] * k_scale;
      } else {
        for (int gi = 0; gi < g; ++gi) p_s[gi * kChunk + tid] = -INFINITY;
      }
      __syncthreads();

      // 2. Online softmax: warp w updates query rows w, w + kWarps, ...
      for (int gi = warp; gi < g; gi += kWarps) {
        float* sr = p_s + gi * kChunk;
        float mx = -INFINITY;
        for (int t = lane; t < kChunk; t += 32) mx = fmaxf(mx, sr[t]);
        mx = warp_max(mx);
        const float m_old = m_s[gi];
        const float m_new = fmaxf(m_old, mx);  // finite: the chunk has a token
        float sum = 0.f;
        for (int t = lane; t < kChunk; t += 32) {
          const float e = expf(sr[t] - m_new);  // 0 past the history
          sr[t] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);  // 0 on the first chunk
          a_s[gi] = alpha;
          l_s[gi] = l_s[gi] * alpha + sum;
          m_s[gi] = m_new;
        }
      }
      __syncthreads();

      // 3. acc = acc * alpha + P @ V: warp w takes 32 of the chunk's tokens.
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < g) {
          const float alpha = a_s[gi];
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[gi][e] *= alpha;
        }
      }
      const int t_end = min(n, (warp + 1) * 32);
#pragma unroll 4
      for (int t = warp * 32; t < t_end; ++t) {
        float vf[kE];
        load_lane<kE>(v_head + off_s[t] + lane * kE, vf);
        float v_scale = 1.f;
        if constexpr (Q8) v_scale = vsc_s[t];
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) {
          if (gi < g) {
            const float p = p_s[gi * kChunk + t] * v_scale;
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[gi][e] = fmaf(p, vf[e], acc[gi][e]);
          }
        }
      }
      __syncthreads();  // p_s / off_s / a_s / vsc_s are rewritten next chunk
    }
  }

  // Every output is written, zero-length rows included: the caller
  // allocates with torch.empty and _combine_current needs m = -inf there.
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    if (gi < g) {
#pragma unroll
      for (int e = 0; e < kE; ++e) red_s[(warp * g + gi) * HD + lane * kE + e] = acc[gi][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < g * HD; i += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red_s[w * g * HD + i];
    if constexpr (kNorm) {
      // l >= 1 wherever len > 0 (the running max contributes exp(0))
      out[row0 * HD + i] = __float2bfloat16(len > 0 ? sum / l_s[i / HD] : 0.f);
    } else {
      acc_out[row0 * HD + i] = sum;
    }
  }
  if constexpr (!kNorm) {
    for (int gi = tid; gi < g; gi += kThreads) {
      m_out[row0 + gi] = len > 0 ? m_s[gi] : -INFINITY;
      l_out[row0 + gi] = len > 0 ? l_s[gi] : 0.f;
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
  int batch, kh, g, hd, ps, max_pages;
  long long s_page, s_tok;
  float scale;
};

template <int HD, bool Q8, int kMaxG, bool kNorm>
int launch_one(const Args& a, cudaStream_t st) {
  const size_t smem = smem_bytes(a.g, HD, Q8);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<HD, Q8, kMaxG, kNorm>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_kernel<HD, Q8, kMaxG, kNorm><<<dim3(a.batch, a.kh), kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const Val<Q8>*>(a.k),
      static_cast<const Val<Q8>*>(a.v), static_cast<const __nv_bfloat16*>(a.k_scales),
      static_cast<const __nv_bfloat16*>(a.v_scales), static_cast<const int32_t*>(a.tables),
      static_cast<const int32_t*>(a.lens), static_cast<float*>(a.acc),
      static_cast<float*>(a.m), static_cast<float*>(a.l),
      static_cast<__nv_bfloat16*>(a.out), a.kh, a.g, a.ps, a.max_pages,
      a.s_page, a.s_tok, a.scale);
  return (int)cudaGetLastError();
}

// The smallest instantiation whose accumulators cover g rows.
template <int HD, bool Q8, bool kNorm>
int launch_hd(const Args& a, cudaStream_t st) {
  if (a.g * HD <= kGroupDim) return launch_one<HD, Q8, kGroupDim / HD, kNorm>(a, st);
  return launch_one<HD, Q8, kMaxGroupDim / HD, kNorm>(a, st);
}

template <bool Q8, bool kNorm>
int launch(const Args& a, void* stream) {
  if (a.batch <= 0 || a.kh <= 0 || a.g <= 0 || a.ps <= 0
      || (long long)a.g * a.hd > kMaxGroupDim) {
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
extern "C" int paged_decode_pool_bf16(
    const void* q, const void* pool, const void* tables, const void* lens,
    void* acc, void* m, void* l,
    int batch, int kh, int g, int hd, int ps, int max_pages,
    long long layer_off, long long s_kv, long long s_page, long long s_tok,
    float scale, void* stream) {
  const auto* k = static_cast<const __nv_bfloat16*>(pool) + layer_off;
  return launch<false, false>(
      Args{q, k, k + s_kv, nullptr, nullptr, tables, lens, acc, m, l, nullptr,
           batch, kh, g, hd, ps, max_pages, s_page, s_tok, scale},
      stream);
}

extern "C" int paged_decode_pool_int8(
    const void* q, const void* pool, const void* scales, const void* tables,
    const void* lens, void* acc, void* m, void* l,
    int batch, int kh, int g, int hd, int ps, int max_pages,
    long long layer_off, long long s_kv, long long s_page, long long s_tok,
    long long sc_layer_off, long long sc_kv, float scale, void* stream) {
  const auto* k = static_cast<const int8_t*>(pool) + layer_off;
  const auto* ks = static_cast<const __nv_bfloat16*>(scales) + sc_layer_off;
  return launch<true, false>(
      Args{q, k, k + s_kv, ks, ks + sc_kv, tables, lens, acc, m, l, nullptr,
           batch, kh, g, hd, ps, max_pages, s_page, s_tok, scale},
      stream);
}

extern "C" int paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lens, void* out,
    int batch, int kh, int g, int hd, int ps, int max_pages,
    long long s_page, long long s_tok, float scale, void* stream) {
  return launch<false, true>(
      Args{q, k_pages, v_pages, nullptr, nullptr, tables, lens, nullptr,
           nullptr, nullptr, out, batch, kh, g, hd, ps, max_pages, s_page,
           s_tok, scale},
      stream);
}

extern "C" int paged_decode_partial_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lens, void* acc, void* m, void* l,
    int batch, int kh, int g, int hd, int ps, int max_pages,
    long long s_page, long long s_tok, float scale, void* stream) {
  return launch<false, false>(
      Args{q, k_pages, v_pages, nullptr, nullptr, tables, lens, acc, m, l,
           nullptr, batch, kh, g, hd, ps, max_pages, s_page, s_tok, scale},
      stream);
}
