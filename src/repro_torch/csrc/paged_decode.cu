// Paged flash-decode for Hopper, sm_90a.
//
// Replaces the reference's Pallas kernels
// src/repro/kernels/paged_attention.py:_decode_kernel_grouped (the default,
// grouped=True) and :_decode_kernel (grouped=False), called through
// kernels/ops.py:paged_decode_bhd from models/attention.py.
//
// What it computes: one new token per sequence against a paged KV pool.
// q (B, K, G, hd); pools (P, K, ps, hd); page_table (B, pps) int32;
// pos_q (B,) int32.  Slot t of a sequence holds position t; a key is live
// iff t <= pos_q and its table entry is >= 0.  pos_q < 0 gives a zero row.
// fp32 online softmax per query row; output acc / max(l, 1e-37).
//
// Design: the TPU grid walked (batch, head tile, page) with the page axis
// sequential and the table scalar-prefetched.  Here the page walk of one
// (batch row, kv head) is cut into n_split contiguous page ranges, each
// walked by its own block with its own online softmax (m, l, acc); a second
// small kernel merges the partial states (flash-decoding).  The split count
// is picked by the wrapper from B * K and the card's SM count, never from
// the head tile, so the grouped grid (a block per tile of kt =
// group_tile(K, G) kv heads) and the per-head grid (kt = 1) run the same
// arithmetic per head and give the same numbers.  A block reads its own
// table row and position and walks only pages <= pos_q / ps, and within a
// page only the live keys; a -1 entry (or one past the pool) is skipped,
// never dereferenced.  Each kv head gets 128 threads and its own shared
// memory.  Keys go through in sub-tiles of 32 (hd 128) or 64 (hd 64):
// scores with hd / 32 threads per key, each loading its 16-byte chunks of
// the key row at once; softmax with one warp per query row; P.V with thread
// d owning output dim d and loading the sub-tile's values of dim d at once,
// so each thread keeps many loads in flight instead of a dependent chain.
//
// Bound on the card: decode is bandwidth bound.  The live K/V bytes are
// (distinct live keys) * K * hd * 2 (K and V) * sizeof(element), with
// distinct live keys = sum_b (pos_q[b] + 1) less the keys of pages that
// several rows share (counted once) and of -1 holes; at 3.35 TB/s
// (H100 SXM) that is the least time.  The split over pages is
// what puts enough blocks on the card's 132 SMs at serving batch sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTH = 128;        // threads per kv head
constexpr int NW = NTH / 32;    // warps per kv head
constexpr int MAXG = 8;         // query rows per kv head
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

// One 16-byte chunk of a key row, widened to fp32.
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_chunk(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}

// floats of shared memory per kv head: scaled q [G][hd], scores or
// probabilities of a sub-tile [G][TK], m, l, corr [G], and the partial
// P.V sums of the key interleave [(NTH / hd) - 1][G][hd]
__host__ __device__ inline int head_floats(int G, int hd) {
  const int tk = NTH * 32 / hd, ksplit = NTH / hd;
  return G * (hd + tk + 3 + (ksplit - 1) * hd);
}

// Partial states, one per (split, b, kv head, query row) = part index
// (split * B + b) * K * G + (h * G + g): m at ws[part], l at ws[NP + part],
// acc at ws[2 NP + part * hd + d], NP = n_split * B * K * G.
template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(1024)
paged_decode_split(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                   const TKV* __restrict__ vp, const int* __restrict__ pt,
                   const int* __restrict__ posq, float* __restrict__ ws,
                   int B, int K, int G, int ps, int pps, int n_pool, int kt,
                   int pages_per_split, float scale, float cap) {
  constexpr int TPK = HD / 32;              // threads per key (scores)
  constexpr int TK = NTH / TPK;             // keys per sub-tile
  constexpr int EPC = 16 / sizeof(TKV);     // elements per 16-byte chunk
  constexpr int NCH = 32 / EPC;             // chunks per thread per key
  constexpr int KSPLIT = NTH / HD;          // key interleave of P.V
  extern __shared__ float smem[];
  const int hl = threadIdx.x / NTH;         // kv head within the tile
  const int tid = threadIdx.x - hl * NTH;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, h = blockIdx.x * kt + hl, split = blockIdx.z;
  float* qs = smem + (size_t)hl * head_floats(G, HD);
  float* sc = qs + G * HD;
  float* m_s = sc + G * TK;
  float* l_s = m_s + G;
  float* c_s = l_s + G;
  float* red = c_s + G;

  const size_t NP = (size_t)gridDim.z * B * K * G;
  const size_t part = ((size_t)split * B + b) * K * G + (size_t)h * G;
  const int pq = posq[b];
  const int last = pq < 0 ? -1 : min(pq / ps, pps - 1);
  const int p0 = split * pages_per_split;
  const int p1 = min(p0 + pages_per_split, last + 1);
  if (p0 >= p1) {  // no live page here (the same for the whole block)
    if (tid < G) {
      ws[part + tid] = NEG_INF;
      ws[NP + part + tid] = 0.f;
    }
    return;
  }

  for (int idx = tid; idx < G * HD; idx += NTH)
    qs[idx] = to_f(q[((size_t)b * K + h) * G * HD + idx]) * scale;
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int d = tid % HD, kq = tid / HD;      // P.V roles
  const int key = tid / TPK, kpart = tid % TPK;  // score roles
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
  const int* row = pt + (size_t)b * pps;
  __syncthreads();

  for (int i = p0; i < p1; ++i) {
    const int entry = row[i];
    if (entry < 0 || entry >= n_pool) continue;   // a hole: nothing to read
    const int nvalid = min(ps, pq - i * ps + 1);  // live keys of this page
    const size_t page = ((size_t)entry * K + h) * ps * HD;
    const TKV* kpage = kp + page;
    const TKV* vpage = vp + page;

    for (int t0 = 0; t0 < nvalid; t0 += TK) {
      const int tn = min(TK, nvalid - t0);        // live keys of the tile
      float dot[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
      if (key < tn) {
        // chunks kpart, kpart + TPK, ...: the TPK threads of a key read
        // neighbouring chunks, and their q reads fall in distinct banks
        const TKV* krow = kpage + (size_t)(t0 + key) * HD;
        float x[NCH][EPC];
#pragma unroll
        for (int j = 0; j < NCH; ++j)
          load_chunk(krow + (kpart + TPK * j) * EPC, x[j]);
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          const int c0 = (kpart + TPK * j) * EPC;
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
#pragma unroll
              for (int e = 0; e < EPC; ++e)
                dot[g] = fmaf(qs[g * HD + c0 + e], x[j][e], dot[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
#pragma unroll
          for (int off = 1; off < TPK; off <<= 1)
            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
          if (kpart == 0 && key < tn) {
            float s = dot[g];
            if (cap != 0.f) s = cap * tanhf(s / cap);
            sc[g * TK + key] = s;
          }
        }
      }
      __syncthreads();

      for (int g = warp; g < G; g += NW) {
        float mx = NEG_INF;
        for (int t = lane; t < tn; t += 32) mx = fmaxf(mx, sc[g * TK + t]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int t = lane; t < tn; t += 32) {
          const float p = expf(sc[g * TK + t] - m_new);
          sc[g * TK + t] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float c = expf(m_old - m_new);
          c_s[g] = c;
          l_s[g] = l_s[g] * c + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();

#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] *= c_s[g];
      // 16 independent value loads in flight per batch of keys
#pragma unroll
      for (int j0 = 0; j0 < TK / KSPLIT; j0 += 16) {
        float vv[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int t = kq + KSPLIT * (j0 + j);
          vv[j] = t < tn ? to_f(vpage[(size_t)(t0 + t) * HD + d]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int t = kq + KSPLIT * (j0 + j);
          if (t < tn) {
#pragma unroll
            for (int g = 0; g < MAXG; ++g)
              if (g < G) acc[g] = fmaf(sc[g * TK + t], vv[j], acc[g]);
          }
        }
      }
      __syncthreads();   // sc, c_s are rewritten by the next sub-tile
    }
  }

  if (kq > 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) red[((kq - 1) * G + g) * HD + d] = acc[g];
  }
  __syncthreads();
  if (kq == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float a = acc[g];
      for (int j = 1; j < KSPLIT; ++j) a += red[((j - 1) * G + g) * HD + d];
      ws[2 * NP + (part + g) * HD + d] = a;
    }
  }
  if (tid < G) {
    ws[part + tid] = m_s[tid];
    ws[NP + part + tid] = l_s[tid];
  }
}

// Merge the n_split partial states of one query row (block) per output
// dim (thread); inactive rows (pos_q < 0) are written as zeros.
template <typename TQ, int HD>
__global__ void __launch_bounds__(HD)
paged_decode_combine(const float* __restrict__ ws,
                     const int* __restrict__ posq, TQ* __restrict__ o,
                     int B, int K, int G, int n_split) {
  const int r = blockIdx.x;                 // (b * K + h) * G + g
  const int d = threadIdx.x;
  const size_t BKG = (size_t)B * K * G, NP = (size_t)n_split * BKG;
  float out = 0.f;
  if (posq[r / (K * G)] >= 0) {
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, ws[s * BKG + r]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float m = ws[s * BKG + r];
      if (m == NEG_INF) continue;             // a split with no live key
      const float w = expf(m - M);
      L = fmaf(ws[NP + s * BKG + r], w, L);
      A = fmaf(ws[2 * NP + (s * BKG + r) * HD + d], w, A);
    }
    out = A / fmaxf(L, 1e-37f);
  }
  o[(size_t)r * HD + d] = from_f<TQ>(out);
}

template <typename TQ, typename TKV, int HD>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* pos, void* ws, void* o, int B, int K, int G, int ps,
           int pps, int n_pool, int kt, int n_split, float scale, float cap,
           cudaStream_t stream) {
  const int smem = head_floats(G, HD) * kt * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_split<TQ, TKV, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int pages_per_split = (pps + n_split - 1) / n_split;
  const dim3 grid(K / kt, B, n_split);
  paged_decode_split<TQ, TKV, HD><<<grid, NTH * kt, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<const int*>(pt),
      static_cast<const int*>(pos), static_cast<float*>(ws), B, K, G, ps,
      pps, n_pool, kt, pages_per_split, scale, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine<TQ, HD><<<B * K * G, HD, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const int*>(pos),
      static_cast<TQ*>(o), B, K, G, n_split);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                const void* pt, const void* pos, void* ws, void* o, int B,
                int K, int G, int ps, int pps, int n_pool, int kt,
                int n_split, float scale, float cap, cudaStream_t st) {
  if (hd == 64)
    return launch<TQ, TKV, 64>(q, kp, vp, pt, pos, ws, o, B, K, G, ps, pps,
                               n_pool, kt, n_split, scale, cap, st);
  if (hd == 128)
    return launch<TQ, TKV, 128>(q, kp, vp, pt, pos, ws, o, B, K, G, ps, pps,
                                n_pool, kt, n_split, scale, cap, st);
  return -1;
}

}  // namespace

// qdt / kvdt: 0 = float32, 1 = bfloat16 (q and o share qdt; float32 q over
// bfloat16 pools is the fp32-compute / bf16-cache configuration).  ws is
// fp32 scratch of n_split * B * K * G * (2 + hd) floats.  All operands
// contiguous, pools 16-byte aligned.  Returns 0 when both kernels were
// launched, a CUDA error code when a launch was refused, -1 for an
// unsupported shape or type.
extern "C" int paged_decode_fwd(const void* q, const void* kp, const void* vp,
                                const void* pt, const void* pos, void* ws,
                                void* o, int qdt, int kvdt, int B, int K,
                                int G, int hd, int ps, int pps, int n_pool,
                                int kt, int n_split, float scale, float cap,
                                void* stream) {
  if (B <= 0 || K <= 0 || G <= 0 || G > MAXG || ps <= 0 || pps <= 0 ||
      n_pool <= 0 || kt <= 0 || K % kt != 0 || kt * NTH > 1024 ||
      n_split <= 0 || n_split > pps)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qdt == 1 && kvdt == 1)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(
        hd, q, kp, vp, pt, pos, ws, o, B, K, G, ps, pps, n_pool, kt, n_split,
        scale, cap, st);
  if (qdt == 0 && kvdt == 0)
    return dispatch_hd<float, float>(hd, q, kp, vp, pt, pos, ws, o, B, K, G,
                                     ps, pps, n_pool, kt, n_split, scale, cap,
                                     st);
  if (qdt == 0 && kvdt == 1)
    return dispatch_hd<float, __nv_bfloat16>(hd, q, kp, vp, pt, pos, ws, o, B,
                                             K, G, ps, pps, n_pool, kt,
                                             n_split, scale, cap, st);
  return -1;
}
