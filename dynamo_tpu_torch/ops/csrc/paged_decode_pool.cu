// Paged flash-decode partials over the whole KV pool, for Hopper: a bf16
// pool and an int8 pool with one bf16 scale per token.
//
// Replaces dynamo_tpu/ops/paged_attention.py::_pool_decode_kernel (behind
// paged_decode_attention_pool): paged_decode_pool_bf16 its bf16 branch,
// paged_decode_pool_int8 its `quantized=True` branch. For every (sequence
// b, kv head h) it runs an online softmax over the GQA group of
// g = qh / kh query heads against that sequence's HISTORY (positions
// < kv_lens_hist[b]; the current token is folded in afterwards by
// _combine_current), reading only the pages the block table owns, and
// writes UNNORMALIZED partials:
//   acc[b, h, gi, :] = sum_t exp(s_t - m) * v_t   (f32)
//   m[b, h, gi], l[b, h, gi] = running max and sum of exp(s_t - m)
// Zero-history rows are written as acc = 0, m = -inf, l = 0.
//
// The int8 pool stores K/V as int8 codes [L, 2, P, ps, kh, hd] and one bf16
// scale per token shared by all kv heads, [L, 2, P, ps]. It dequantizes in
// the loop: the score is (q . k_codes) * k_scale, and each probability is
// multiplied by the token's v_scale before the P.V accumulation, so a code
// row is read once and never widened in memory.
//
// Bound on this card: HBM bytes. Each history token's K and V rows (2 * hd
// values per kv head, 2 bytes each in bf16, 1 in int8) are read once and
// reused by all g query heads; the arithmetic is 4 * g * hd flops per
// token, far below the bytes' time.
//
// Design (simple and right first): grid (B, kh), one block of 128 threads
// per (sequence, kv head). The block walks the history 128 tokens (8 pages
// of 16) per iteration, like the JAX kernel's page chunks:
//   1. scores: one token per thread; the thread resolves its page through
//      the block table and reads the token's whole K row in 8-value loads,
//      dotting it with the g query rows held in shared memory;
//   2. online softmax: one warp per query head updates the running max and
//      sum over the chunk and turns the scores into probabilities;
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
constexpr int kMaxGroupDim = 1024;  // largest g * hd

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

template <int HD, bool Q8>
__global__ void __launch_bounds__(kThreads)
pool_decode_kernel(const __nv_bfloat16* __restrict__ q,  // [B, kh * g, HD]
                   const typename std::conditional<Q8, int8_t, __nv_bfloat16>::type*
                       __restrict__ pool,                 // [L, 2, P, ps, kh, HD]
                   const __nv_bfloat16* __restrict__ scales,  // [L, 2, P, ps] (Q8)
                   const int32_t* __restrict__ tables,    // [B, max_pages]
                   const int32_t* __restrict__ lens,      // [B] history lengths
                   float* __restrict__ acc_out,           // [B, kh, g, HD]
                   float* __restrict__ m_out,             // [B, kh, g]
                   float* __restrict__ l_out,             // [B, kh, g]
                   int kh, int g, int ps, int max_pages,
                   int64_t layer_off, int64_t s_kv, int64_t s_page,
                   int64_t s_tok, int64_t sc_layer_off, int64_t sc_kv,
                   float scale) {
  static_assert(HD == 64 || HD == 128, "HD must be 64 or 128");
  using T = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  constexpr int kLoads = HD / 8;               // 8-value loads per K row
  constexpr int kE = HD / 32;                  // head dims per lane in P.V
  constexpr int kMaxG = kMaxGroupDim / HD;

  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* off_s = reinterpret_cast<int64_t*>(smem);  // [kChunk] K row offsets
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

    const T* k_layer = pool + layer_off + (int64_t)h * HD;
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
        const T* kr = k_layer + off;
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
          const int64_t soff = sc_layer_off + (int64_t)page * ps + off_tok;
          k_scale *= __bfloat162float(scales[soff]);
          vsc_s[tid] = __bfloat162float(scales[soff + sc_kv]);
        }
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi)
          if (gi < g) p_s[gi * kChunk + tid] = s[gi] * k_scale;
      } else {
        for (int gi = 0; gi < g; ++gi) p_s[gi * kChunk + tid] = -INFINITY;
      }
      __syncthreads();

      // 2. Online softmax: warp w updates query heads w, w + kWarps, ...
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
        load_lane<kE>(k_layer + off_s[t] + s_kv + lane * kE, vf);
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

  // Every output is written, zero-history rows included: the caller
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
    acc_out[row0 * HD + i] = sum;
  }
  for (int gi = tid; gi < g; gi += kThreads) {
    m_out[row0 + gi] = len > 0 ? m_s[gi] : -INFINITY;
    l_out[row0 + gi] = len > 0 ? l_s[gi] : 0.f;
  }
}

template <bool Q8>
int launch(const void* q, const void* pool, const void* scales,
           const void* tables, const void* lens, void* acc, void* m, void* l,
           int batch, int kh, int g, int hd, int ps, int max_pages,
           long long layer_off, long long s_kv, long long s_page,
           long long s_tok, long long sc_layer_off, long long sc_kv,
           float scale, void* stream) {
  if (batch <= 0 || kh <= 0 || g <= 0 || ps <= 0 || g * hd > kMaxGroupDim) {
    return (int)cudaErrorInvalidValue;
  }
  using T = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  const dim3 grid(batch, kh);
  const size_t smem = smem_bytes(g, hd, Q8);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* pp = static_cast<const T*>(pool);
  const auto* sp = static_cast<const __nv_bfloat16*>(scales);
  const auto* tp = static_cast<const int32_t*>(tables);
  const auto* lp = static_cast<const int32_t*>(lens);
  auto* ap = static_cast<float*>(acc);
  auto* mp = static_cast<float*>(m);
  auto* lo = static_cast<float*>(l);
  if (hd == 128) {
    pool_decode_kernel<128, Q8><<<grid, kThreads, smem, st>>>(
        qp, pp, sp, tp, lp, ap, mp, lo, kh, g, ps, max_pages,
        layer_off, s_kv, s_page, s_tok, sc_layer_off, sc_kv, scale);
  } else if (hd == 64) {
    pool_decode_kernel<64, Q8><<<grid, kThreads, smem, st>>>(
        qp, pp, sp, tp, lp, ap, mp, lo, kh, g, ps, max_pages,
        layer_off, s_kv, s_page, s_tok, sc_layer_off, sc_kv, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 = launched).
// Strides are in elements of the contiguous pool; `layer_off` already
// includes layer * stride(0). For the int8 pool, `sc_layer_off` and `sc_kv`
// index the contiguous [L, 2, P, ps] scales the same way.
extern "C" int paged_decode_pool_bf16(
    const void* q, const void* pool, const void* tables, const void* lens,
    void* acc, void* m, void* l,
    int batch, int kh, int g, int hd, int ps, int max_pages,
    long long layer_off, long long s_kv, long long s_page, long long s_tok,
    float scale, void* stream) {
  return launch<false>(q, pool, nullptr, tables, lens, acc, m, l, batch, kh,
                       g, hd, ps, max_pages, layer_off, s_kv, s_page, s_tok,
                       0, 0, scale, stream);
}

extern "C" int paged_decode_pool_int8(
    const void* q, const void* pool, const void* scales, const void* tables,
    const void* lens, void* acc, void* m, void* l,
    int batch, int kh, int g, int hd, int ps, int max_pages,
    long long layer_off, long long s_kv, long long s_page, long long s_tok,
    long long sc_layer_off, long long sc_kv, float scale, void* stream) {
  return launch<true>(q, pool, scales, tables, lens, acc, m, l, batch, kh, g,
                      hd, ps, max_pages, layer_off, s_kv, s_page, s_tok,
                      sc_layer_off, sc_kv, scale, stream);
}
