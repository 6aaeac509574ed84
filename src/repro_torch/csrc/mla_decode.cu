// MLA latent paged flash-decode for Hopper, sm_90a.
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/paged_attention.py:_decode_kernel_mla, called through
// kernels/ops.py:mla_paged_decode_bhd from models/attention.py:mla_attention
// on every decode step of every MLA layer (deepseek-v2).
//
// What it computes: one new token per sequence against the paged latent
// pool.  q_lat (B, H, lora + rd) is the query absorbed through W_kc,
// concatenated with its rotated rope part; ckv_pages (P, ps, lora) and
// krope_pages (P, ps, rd) hold the latents and the shared rope keys;
// page_table (B, pps) int32; pos_q (B,) int32.  Every head scores the same
// keys [ckv ‖ krope] (the cache is MQA-shaped: one latent kv head), with
// an fp32 online softmax per head, and the latent itself is the value:
// out (B, H, lora) = sum_t p_t ckv_t / sum_t p_t, in q's dtype.  Slot t of
// a sequence holds position t; a key is live iff t <= pos_q and its table
// entry is >= 0; pos_q < 0 gives a zero row; a -1 entry, or one past the
// pool, is never dereferenced.
//
// Design: the TPU grid walked (batch, page) with one program holding all
// H heads and the page axis sequential.  Here a block takes one (row,
// tile of 16 heads, page range); the page walk of a (row, head tile) is
// cut into n_split ranges, each with its own online softmax, and a second
// kernel merges the partial states (flash-decoding, as csrc/paged_decode.cu
// does).  A block reads its own table row and position and walks only the
// pages <= pos_q / ps.  Because every head reads the same keys, a 32-key
// sub-tile of [ckv ‖ krope] comes into shared memory once and serves the
// block's 16 heads; the 16 scaled query rows stay in shared memory as fp32.
// Scores: each thread owns 2 heads x 4 keys over a quarter of the 576
// dims (float4 query and 4-element key loads, 32 FMAs per 6 loads), and
// the quarters are summed with two shuffles.  Softmax: one warp per head,
// one lane per key.  P.V stays in fp32 (as the reference keeps it): each
// thread owns 2 of the 512 latent dims for all 16 heads (32 accumulators)
// and reads each key's 2 values and the 16 probabilities (broadcast).  Key
// rows are padded by 16 bytes in shared memory so the score loads of a
// warp spread over the banks.  Dead slots of a live page are zero-filled,
// never read.  Everything is fp32 SIMT: bf16 keys are widened on load.
//
// Bound on the card: reading the live latent keys once, (distinct live
// keys) x (lora + rd) x sizeof(element), at 3.35 TB/s, against
// sum_rows (live keys) x H x (576 + 512) x 2 operations; at deepseek-v2's
// serving shape in bf16 the bytes bound.  This fp32 SIMT kernel is held to
// the fp32 rate instead, which puts it well above that bound; the
// tensor-core version (mma.sync for the scores) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTH = 256;        // threads per block
constexpr int HT = 16;          // heads per block (2 per warp)
constexpr int TK = 32;          // keys per shared-memory sub-tile
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// 4 and 2 consecutive elements widened to fp32 (8- or 16-byte, and 4- or
// 8-byte aligned loads)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Shared memory of a block, in bytes: the scaled query tile [HT][DQ]
// fp32, the key sub-tile [TK][RS] in the pool's type (RS = DQ + 16 bytes
// of padding), the scores [HT][TK] and probabilities [TK][HT] fp32, and
// m, l, corr [HT].
template <typename TKV, int DQ>
__host__ __device__ constexpr int key_stride() {
  return DQ + 16 / (int)sizeof(TKV);
}
template <typename TKV, int DQ>
__host__ __device__ constexpr int smem_bytes() {
  return HT * DQ * 4 + TK * key_stride<TKV, DQ>() * (int)sizeof(TKV) +
         2 * HT * TK * 4 + 3 * HT * 4;
}

// Partial states, one per (split, b, head) = part index (split * B + b) *
// H + h: m at ws[part], l at ws[NP + part], acc at ws[2 NP + part * LORA +
// d], NP = n_split * B * H.
template <typename TQ, typename TKV, int LORA, int RD>
__global__ void __launch_bounds__(NTH, 2)
mla_decode_split(const TQ* __restrict__ q, const TKV* __restrict__ ckv,
                 const TKV* __restrict__ krope, const int* __restrict__ pt,
                 const int* __restrict__ posq, float* __restrict__ ws, int B,
                 int H, int ps, int pps, int n_pool, int pages_per_split,
                 float scale) {
  constexpr int DQ = LORA + RD;
  constexpr int RS = key_stride<TKV, DQ>();
  constexpr int EPC = 16 / sizeof(TKV);           // elements per 16 bytes
  constexpr int CPK_L = LORA / EPC, CPK = DQ / EPC;  // chunks per key row
  static_assert(LORA == 2 * NTH, "P.V gives each thread 2 latent dims");
  static_assert(DQ % 16 == 0 && LORA % EPC == 0 && RD % EPC == 0,
                "score quarters and 16-byte chunks tile the key row");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  TKV* ks = reinterpret_cast<TKV*>(smem_raw + HT * DQ * 4);
  float* ss = reinterpret_cast<float*>(smem_raw + HT * DQ * 4 +
                                       TK * RS * sizeof(TKV));
  float* pp = ss + HT * TK;                       // [TK][HT]
  float* m_s = pp + TK * HT;
  float* l_s = m_s + HT;
  float* c_s = l_s + HT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, h0 = blockIdx.x * HT, split = blockIdx.z;
  const size_t NP = (size_t)gridDim.z * B * H;
  const size_t part0 = ((size_t)split * B + b) * H + h0;
  const int pq = posq[b];
  const int last = pq < 0 ? -1 : min(pq / ps, pps - 1);
  const int p0 = split * pages_per_split;
  const int p1 = min(p0 + pages_per_split, last + 1);
  if (p0 >= p1) {  // no live page here (the same for the whole block)
    if (tid < HT && h0 + tid < H) {
      ws[part0 + tid] = NEG_INF;
      ws[NP + part0 + tid] = 0.f;
    }
    return;
  }

  for (int idx = tid; idx < HT * DQ; idx += NTH) {
    const int h = idx / DQ;
    qs[idx] = h0 + h < H
                  ? to_f(q[((size_t)b * H + h0) * DQ + idx]) * scale
                  : 0.f;
  }
  if (tid < HT) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  // score roles: quarter qe of the dims, keys kg + 8 i, heads 2 warp + {0,1}
  const int qe = lane & 3, kg = lane >> 2;
  const int ha = 2 * warp;
  // P.V role: latent dims 2 tid, 2 tid + 1
  const int d0 = 2 * tid;
  float acc[HT][2];
#pragma unroll
  for (int h = 0; h < HT; ++h) acc[h][0] = acc[h][1] = 0.f;
  const int* row = pt + (size_t)b * pps;
  __syncthreads();

  for (int i = p0; i < p1; ++i) {
    const int entry = row[i];
    if (entry < 0 || entry >= n_pool) continue;   // a hole: nothing to read
    const int nvalid = min(ps, pq - i * ps + 1);  // live keys of this page
    const TKV* cpage = ckv + (size_t)entry * ps * LORA;
    const TKV* rpage = krope + (size_t)entry * ps * RD;

    for (int t0 = 0; t0 < nvalid; t0 += TK) {
      const int tn = min(TK, nvalid - t0);        // live keys of the tile
      // keys [ckv ‖ krope] of the tile into shared memory, 16 bytes a
      // chunk; dead slots are zero-filled
      for (int idx = tid; idx < TK * CPK; idx += NTH) {
        const int t = idx / CPK, ch = idx - t * CPK;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (t < tn) {
          const TKV* src =
              ch < CPK_L ? cpage + (size_t)(t0 + t) * LORA + ch * EPC
                         : rpage + (size_t)(t0 + t) * RD + (ch - CPK_L) * EPC;
          v = *reinterpret_cast<const uint4*>(src);
        }
        *reinterpret_cast<uint4*>(ks + t * RS + ch * EPC) = v;
      }
      __syncthreads();

      // scores of heads ha, ha + 1 against keys kg + 8 i over the dims of
      // quarter qe (chunks of 4 interleaved across the quarters)
      float dot[2][4];
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) dot[0][i4] = dot[1][i4] = 0.f;
#pragma unroll 4
      for (int j = 0; j < DQ / 16; ++j) {
        const int e0 = 4 * (qe + 4 * j);
        const float4 qa = *reinterpret_cast<const float4*>(qs + ha * DQ + e0);
        const float4 qb =
            *reinterpret_cast<const float4*>(qs + (ha + 1) * DQ + e0);
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          const float4 k = load4(ks + (kg + 8 * i4) * RS + e0);
          dot[0][i4] = dot4(qa, k, dot[0][i4]);
          dot[1][i4] = dot4(qb, k, dot[1][i4]);
        }
      }
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          dot[hh][i4] += __shfl_xor_sync(0xffffffffu, dot[hh][i4], 1);
          dot[hh][i4] += __shfl_xor_sync(0xffffffffu, dot[hh][i4], 2);
        }
      }
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
        if (i4 == qe) {                 // lane qe writes key kg + 8 qe
          const int t = kg + 8 * i4;
          ss[ha * TK + t] = t < tn ? dot[0][i4] : NEG_INF;
          ss[(ha + 1) * TK + t] = t < tn ? dot[1][i4] : NEG_INF;
        }
      }
      __syncthreads();

      // online softmax: warp w updates heads 2w, 2w + 1, lane = key
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int h = ha + hh;
        const float s = ss[h * TK + lane];
        float mx = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[h];
        const float m_new = fmaxf(m_old, mx);
        const float p = lane < tn ? expf(s - m_new) : 0.f;
        pp[lane * HT + h] = p;
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float c = expf(m_old - m_new);
          c_s[h] = c;
          l_s[h] = l_s[h] * c + sum;
          m_s[h] = m_new;
        }
      }
      __syncthreads();

      // P.V in fp32 against the latent part of the keys
#pragma unroll
      for (int h = 0; h < HT; ++h) {
        const float c = c_s[h];
        acc[h][0] *= c;
        acc[h][1] *= c;
      }
      for (int t = 0; t < tn; ++t) {
        const float2 v = load2(ks + t * RS + d0);
        const float4* pr = reinterpret_cast<const float4*>(pp + t * HT);
#pragma unroll
        for (int g = 0; g < HT / 4; ++g) {
          const float4 p4 = pr[g];
          acc[4 * g][0] = fmaf(p4.x, v.x, acc[4 * g][0]);
          acc[4 * g][1] = fmaf(p4.x, v.y, acc[4 * g][1]);
          acc[4 * g + 1][0] = fmaf(p4.y, v.x, acc[4 * g + 1][0]);
          acc[4 * g + 1][1] = fmaf(p4.y, v.y, acc[4 * g + 1][1]);
          acc[4 * g + 2][0] = fmaf(p4.z, v.x, acc[4 * g + 2][0]);
          acc[4 * g + 2][1] = fmaf(p4.z, v.y, acc[4 * g + 2][1]);
          acc[4 * g + 3][0] = fmaf(p4.w, v.x, acc[4 * g + 3][0]);
          acc[4 * g + 3][1] = fmaf(p4.w, v.y, acc[4 * g + 3][1]);
        }
      }
      __syncthreads();   // ks, ss, pp and c_s are rewritten by the next tile
    }
  }

#pragma unroll
  for (int h = 0; h < HT; ++h) {
    if (h0 + h < H) {
      float* dst = ws + 2 * NP + (part0 + h) * LORA + d0;
      *reinterpret_cast<float2*>(dst) = make_float2(acc[h][0], acc[h][1]);
    }
  }
  if (tid < HT && h0 + tid < H) {
    ws[part0 + tid] = m_s[tid];
    ws[NP + part0 + tid] = l_s[tid];
  }
}

// Merge the n_split partial states of one (row, head) (block), the
// threads striding over the latent dims; inactive rows (pos_q < 0) are
// written as zeros.
template <typename TQ, int LORA>
__global__ void __launch_bounds__(256)
mla_decode_combine(const float* __restrict__ ws, const int* __restrict__ posq,
                   TQ* __restrict__ o, int B, int H, int n_split) {
  const int r = blockIdx.x;                 // b * H + h
  const size_t BH = (size_t)B * H, NP = (size_t)n_split * BH;
  const bool live = posq[r / H] >= 0;
  float M = NEG_INF;
  if (live)
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, ws[s * BH + r]);
  for (int d = threadIdx.x; d < LORA; d += blockDim.x) {
    float out = 0.f;
    if (live) {
      float L = 0.f, A = 0.f;
      for (int s = 0; s < n_split; ++s) {
        const float m = ws[s * BH + r];
        if (m == NEG_INF) continue;           // a split with no live key
        const float w = expf(m - M);
        L = fmaf(ws[NP + s * BH + r], w, L);
        A = fmaf(ws[2 * NP + (s * BH + r) * LORA + d], w, A);
      }
      out = A / fmaxf(L, 1e-37f);
    }
    o[(size_t)r * LORA + d] = from_f<TQ>(out);
  }
}

template <typename TQ, typename TKV, int LORA, int RD>
int launch(const void* q, const void* ckv, const void* krope, const void* pt,
           const void* pos, void* ws, void* o, int B, int H, int ps, int pps,
           int n_pool, int n_split, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<TKV, LORA + RD>();
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_split<TQ, TKV, LORA, RD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int pages_per_split = (pps + n_split - 1) / n_split;
  const dim3 grid((H + HT - 1) / HT, B, n_split);
  mla_decode_split<TQ, TKV, LORA, RD><<<grid, NTH, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(ckv),
      static_cast<const TKV*>(krope), static_cast<const int*>(pt),
      static_cast<const int*>(pos), static_cast<float*>(ws), B, H, ps, pps,
      n_pool, pages_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_decode_combine<TQ, LORA><<<B * H, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const int*>(pos),
      static_cast<TQ*>(o), B, H, n_split);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int dispatch_dims(int lora, int rd, const void* q, const void* ckv,
                  const void* krope, const void* pt, const void* pos,
                  void* ws, void* o, int B, int H, int ps, int pps,
                  int n_pool, int n_split, float scale, cudaStream_t st) {
  if (lora == 512 && rd == 64)
    return launch<TQ, TKV, 512, 64>(q, ckv, krope, pt, pos, ws, o, B, H, ps,
                                    pps, n_pool, n_split, scale, st);
  return -1;
}

}  // namespace

// qdt / kvdt: 0 = float32, 1 = bfloat16 (q and o share qdt; a float32 q
// over bfloat16 pools is the fp32-compute / bf16-cache configuration).  ws
// is fp32 scratch of n_split * B * H * (2 + lora) floats.  All operands
// contiguous, pools 16-byte aligned.  Returns 0 when both kernels were
// launched, a CUDA error code when a launch was refused, -1 for an
// unsupported shape or type.
extern "C" int mla_decode_fwd(const void* q, const void* ckv,
                              const void* krope, const void* pt,
                              const void* pos, void* ws, void* o, int qdt,
                              int kvdt, int B, int H, int lora, int rd,
                              int ps, int pps, int n_pool, int n_split,
                              float scale, void* stream) {
  if (B <= 0 || H <= 0 || ps <= 0 || pps <= 0 || n_pool <= 0 ||
      n_split <= 0 || n_split > pps)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qdt == 1 && kvdt == 1)
    return dispatch_dims<__nv_bfloat16, __nv_bfloat16>(
        lora, rd, q, ckv, krope, pt, pos, ws, o, B, H, ps, pps, n_pool,
        n_split, scale, st);
  if (qdt == 0 && kvdt == 0)
    return dispatch_dims<float, float>(lora, rd, q, ckv, krope, pt, pos, ws,
                                       o, B, H, ps, pps, n_pool, n_split,
                                       scale, st);
  if (qdt == 0 && kvdt == 1)
    return dispatch_dims<float, __nv_bfloat16>(lora, rd, q, ckv, krope, pt,
                                               pos, ws, o, B, H, ps, pps,
                                               n_pool, n_split, scale, st);
  return -1;
}
