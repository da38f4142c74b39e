// Paged flash-decode partials over the whole KV pool, bf16, for Hopper.
//
// Replaces dynamo_tpu/ops/paged_attention.py::_pool_decode_kernel (the bf16
// branch behind paged_decode_attention_pool). For every (sequence b, kv head
// h) it runs an online softmax over the GQA group of g = qh / kh query heads
// against that sequence's HISTORY (positions < kv_lens_hist[b]; the current
// token is folded in afterwards by _combine_current), reading only the pages
// the block table owns, and writes UNNORMALIZED partials:
//   acc[b, h, gi, :] = sum_t exp(s_t - m) * v_t   (f32)
//   m[b, h, gi], l[b, h, gi] = running max and sum of exp(s_t - m)
// Zero-history rows are written as acc = 0, m = -inf, l = 0.
//
// Bound on this card: HBM bytes. Each history token's K and V rows (2 * hd
// bf16 per kv head) are read once and reused by all g query heads; the
// arithmetic is 4 * g * hd flops per token, far below the bytes' time.
//
// Design (simple and right first): grid (B, kh), one block of 128 threads
// per (sequence, kv head). The block walks the history 128 tokens (8 pages
// of 16) per iteration, like the JAX kernel's page chunks:
//   1. scores: one token per thread; the thread resolves its page through
//      the block table and reads the token's whole K row in 16-byte loads,
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

size_t smem_bytes(int g, int hd) {
  return sizeof(int64_t) * kChunk
         + sizeof(float) * ((size_t)g * hd * (1 + kWarps) + (size_t)g * kChunk + 3 * (size_t)g);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
pool_decode_kernel(const __nv_bfloat16* __restrict__ q,     // [B, kh * g, HD]
                   const __nv_bfloat16* __restrict__ pool,  // [L, 2, P, ps, kh, HD]
                   const int32_t* __restrict__ tables,      // [B, max_pages]
                   const int32_t* __restrict__ lens,        // [B] history lengths
                   float* __restrict__ acc_out,             // [B, kh, g, HD]
                   float* __restrict__ m_out,               // [B, kh, g]
                   float* __restrict__ l_out,               // [B, kh, g]
                   int kh, int g, int ps, int max_pages,
                   int64_t layer_off, int64_t s_kv, int64_t s_page,
                   int64_t s_tok, float scale) {
  static_assert(HD == 64 || HD == 128, "HD must be 64 or 128");
  constexpr int kLoads = HD / 8;               // 16-byte loads per K row
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

    const __nv_bfloat16* k_layer = pool + layer_off + (int64_t)h * HD;
    const int32_t* table = tables + (int64_t)b * max_pages;
    for (int c0 = 0; c0 < len; c0 += kChunk) {
      const int n = min(kChunk, len - c0);

      // 1. Scores: thread t scores history token c0 + t.
      if (tid < n) {
        const int pos = c0 + tid;
        const int64_t off = (int64_t)table[pos / ps] * s_page + (int64_t)(pos % ps) * s_tok;
        off_s[tid] = off;
        const uint4* kr = reinterpret_cast<const uint4*>(k_layer + off);
        float s[kMaxG];
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) s[gi] = 0.f;
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const uint4 raw = kr[j];
          float kf[8];
          bf16x2_to_float(raw.x, kf);
          bf16x2_to_float(raw.y, kf + 2);
          bf16x2_to_float(raw.z, kf + 4);
          bf16x2_to_float(raw.w, kf + 6);
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
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi)
          if (gi < g) p_s[gi * kChunk + tid] = s[gi] * scale;
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
        const __nv_bfloat16* vr = k_layer + off_s[t] + s_kv + lane * kE;
        float vf[kE];
        if constexpr (kE == 4) {
          const uint2 raw = *reinterpret_cast<const uint2*>(vr);
          bf16x2_to_float(raw.x, vf);
          bf16x2_to_float(raw.y, vf + 2);
        } else {
          bf16x2_to_float(*reinterpret_cast<const uint32_t*>(vr), vf);
        }
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) {
          if (gi < g) {
            const float p = p_s[gi * kChunk + t];
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[gi][e] = fmaf(p, vf[e], acc[gi][e]);
          }
        }
      }
      __syncthreads();  // p_s / off_s / a_s are rewritten by the next chunk
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

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Strides are in elements of the contiguous pool; `layer_off` already
// includes layer * stride(0).
extern "C" int paged_decode_pool_bf16(
    const void* q, const void* pool, const void* tables, const void* lens,
    void* acc, void* m, void* l,
    int batch, int kh, int g, int hd, int ps, int max_pages,
    long long layer_off, long long s_kv, long long s_page, long long s_tok,
    float scale, void* stream) {
  if (batch <= 0 || kh <= 0 || g <= 0 || ps <= 0 || g * hd > kMaxGroupDim) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(batch, kh);
  const size_t smem = smem_bytes(g, hd);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* pp = static_cast<const __nv_bfloat16*>(pool);
  const auto* tp = static_cast<const int32_t*>(tables);
  const auto* lp = static_cast<const int32_t*>(lens);
  auto* ap = static_cast<float*>(acc);
  auto* mp = static_cast<float*>(m);
  auto* lo = static_cast<float*>(l);
  if (hd == 128) {
    pool_decode_kernel<128><<<grid, kThreads, smem, st>>>(
        qp, pp, tp, lp, ap, mp, lo, kh, g, ps, max_pages,
        layer_off, s_kv, s_page, s_tok, scale);
  } else if (hd == 64) {
    pool_decode_kernel<64><<<grid, kThreads, smem, st>>>(
        qp, pp, tp, lp, ap, mp, lo, kh, g, ps, max_pages,
        layer_off, s_kv, s_page, s_tok, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
