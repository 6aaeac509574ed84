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
// iff t <= pos_q and its table entry is in [0, P).  pos_q < 0 gives a zero
// row.  fp32 online softmax per query row; output acc / max(l, 1e-37).
//
// Design: one launch.  The TPU grid walked (batch, head tile, page) with
// the page axis sequential and the table scalar-prefetched.  Here the key
// axis of every (row b, kv head h) is cut into tiles of TK = 32 keys that
// never cross a page (a page holds ceil(ps / 32) tiles), and the tiles
// into n_split ranges of `tps` tiles.  A work item is (b, h, range, query
// row group): one warp walks the range's tiles with its rows' online
// softmax (m, l, acc) in registers.  The decomposition comes from shapes
// alone (the wrapper sizes tps so that the work items fill the card); a
// range that starts past pos_q exits at once, so nothing on the host reads
// the table or the positions.
//
// A block holds the warps of kt kv heads (kt = group_tile(K, G) for the
// grouped grid, 1 for the per-head grid) for one (b, range), and n_gg
// warps a head when G needs more query rows than one warp keeps (GT rows a
// warp: 8, or 4 at hd 256).  Each head of the block streams its live tiles
// through a ring of `stages` shared-memory stages: one lane issues
// cp.async.bulk copies of the tile's K and V rows (contiguous in the
// pool: ps * hd elements a (page, head)) behind a full mbarrier, and the
// head's warps return each stage through an empty mbarrier.  A -1 entry or
// one past the pool is skipped and never dereferenced; keys past pos_q are
// not copied.  Per tile a lane holds hd / 32 dims of every query row: it
// forms its part of the scores of 4 keys at a time, a reduce-scatter over
// the warp leaves each lane the full score of one key, the softmax runs in
// the warp's registers, and P V reads the probabilities from a small
// per-warp buffer and the V rows from the stage.  The arithmetic of a
// (b, h, row) depends on neither kt nor the ring depth, so both grids give
// the same numbers, bit for bit.
//
// Merge in the same launch: each warp of a range that is not alone stores
// its partial (m, l, acc) and takes a ticket from a counter per (b, h,
// row group); the warp that draws the last ticket merges every range of
// that group in range order, writes the output and resets the counter to
// 0, so the counters are zero between launches and need no memset.  A row
// whose walk is a single range writes its output directly.
//
// Bound on the card: decode is bandwidth bound.  The live K/V bytes are
// (distinct live keys) * K * hd * 2 (K and V) * sizeof(element), with
// distinct live keys = sum_b (pos_q[b] + 1) less the keys of pages that
// several rows share (counted once) and of -1 holes; at 3.35 TB/s
// (H100 SXM) that is the least time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TK = 32;          // keys per tile: one per lane
constexpr int KC = 4;           // keys per reduce-scatter
constexpr int MAX_WARPS = 8;    // warps a block (255 registers a thread)
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

// DPL consecutive elements from shared memory, widened to fp32.
template <int DPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&x)[DPL]) {
  static_assert(DPL == 2 || DPL == 4 || DPL == 8, "DPL");
  uint32_t w[DPL / 2];
  if constexpr (DPL == 2) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (DPL == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  }
#pragma unroll
  for (int i = 0; i < DPL / 2; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <int DPL>
__device__ __forceinline__ void load_row(const float* p, float (&x)[DPL]) {
  if constexpr (DPL == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    x[0] = u.x;
    x[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < DPL; i += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + i);
      x[i] = u.x;
      x[i + 1] = u.y;
      x[i + 2] = u.z;
      x[i + 3] = u.w;
    }
  }
}

// DPL consecutive floats of global memory, past L1 (another SM wrote them)
template <int DPL>
__device__ __forceinline__ void load_global(const float* p, float (&x)[DPL]) {
  if constexpr (DPL == 2) {
    const float2 u = __ldcg(reinterpret_cast<const float2*>(p));
    x[0] = u.x;
    x[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < DPL; i += 4) {
      const float4 u = __ldcg(reinterpret_cast<const float4*>(p + i));
      x[i] = u.x;
      x[i + 1] = u.y;
      x[i + 2] = u.z;
      x[i + 3] = u.w;
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// bytes (a multiple of 16) from global to shared, completion on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The tiles of one (row, range): tile tau is keys k0 .. k0 + nv - 1 of
// page tau / ntp, live if its table entry is in the pool.
struct Walk {
  const int* row;
  int ps, ntp, pos, n_pool, end;   // end: one past the range's last tile
  __device__ __forceinline__ int next(int tau) const {   // first live >= tau
    for (; tau < end; ++tau) {
      const int e = row[tau / ntp];
      if (e >= 0 && e < n_pool) break;
    }
    return tau;
  }
  __device__ __forceinline__ int entry(int tau) const { return row[tau / ntp]; }
  __device__ __forceinline__ int first_key(int tau) const {
    return (tau / ntp) * ps + (tau % ntp) * TK;
  }
  __device__ __forceinline__ int keys(int tau) const {
    const int j = tau % ntp;
    return min(min(TK, ps - j * TK), pos - first_key(tau) + 1);
  }
};

template <typename TQ, typename TKV, int HD, int GT>
__global__ void __launch_bounds__(32 * MAX_WARPS)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp, const int* __restrict__ pt,
                    const int* __restrict__ posq, float* __restrict__ ws,
                    int* __restrict__ tickets, TQ* __restrict__ o, int B,
                    int K, int G, int ps, int pps, int n_pool, int kt,
                    int n_gg, int ggb, int tps, int n_split, int stages,
                    float scale, float cap) {
  constexpr int DPL = HD / 32;               // dims a lane holds
  constexpr int TILE = TK * HD * (int)sizeof(TKV);   // K or V of a tile
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hl = warp / ggb, gl = warp - hl * ggb;   // head, group in block
  const int nb = n_gg / ggb;                          // blocks a head tile
  const int ht = blockIdx.x / nb;
  const int gg = (blockIdx.x - ht * nb) * ggb + gl;
  const int h = ht * kt + hl, b = blockIdx.y, sp = blockIdx.z;
  const int gr = (G + n_gg - 1) / n_gg;      // query rows per row group
  const int g0 = gg * gr, gn = min(gr, G - g0);
  unsigned char* ring = smem + (size_t)hl * stages * 2 * TILE;
  float* pbuf = reinterpret_cast<float*>(smem + (size_t)kt * stages * 2 *
                                         TILE) + warp * TK * GT;
  const uint32_t bars = smem_u32(smem + (size_t)kt * stages * 2 * TILE +
                                 (size_t)kt * ggb * TK * GT * 4) +
                        16 * stages * hl;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (stages + s); };

  const int pos = posq[b];
  const int ntp = (ps + TK - 1) / TK;
  const size_t qrow = ((size_t)b * K + h) * G + g0;    // first row's index
  if (pos < 0) {                 // an inactive slot: range 0 writes zeros
    if (sp == 0)
      for (int idx = lane; idx < gn * HD; idx += 32)
        o[qrow * HD + idx] = from_f<TQ>(0.f);
    return;
  }
  const int last_page = pos / ps;
  const int last_tile = last_page >= pps
                            ? pps * ntp - 1
                            : last_page * ntp + (pos - last_page * ps) / TK;
  const int tau0 = sp * tps;
  if (tau0 > last_tile) return;  // the whole block: b and sp are uniform
  const int n_live = last_tile / tps + 1;    // ranges holding live keys
  const Walk walk{pt + (size_t)b * pps, ps, ntp, pos, n_pool,
                  min(tau0 + tps, last_tile + 1)};

  if (threadIdx.x == 0) {
    for (int i = 0; i < kt * stages; ++i) {
      const uint32_t hb = smem_u32(smem + (size_t)kt * stages * 2 * TILE +
                                   (size_t)kt * ggb * TK * GT * 4) +
                          16 * stages * (i / stages) + 8 * (i % stages);
      mbar_init(hb, 1);
      mbar_init(hb + 8 * stages, ggb);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const size_t head_page = (size_t)K * ps * HD;        // one pool entry
  const TKV* kh = kp + (size_t)h * ps * HD;
  const TKV* vh = vp + (size_t)h * ps * HD;
  const bool producer = gl == 0 && lane == 0;
  auto issue = [&](int tau, int s) {
    const int nv = walk.keys(tau);
    const size_t off = (size_t)walk.entry(tau) * head_page +
                       (size_t)(walk.first_key(tau) - (tau / ntp) * ps) * HD;
    const uint32_t bytes = nv * HD * (int)sizeof(TKV);
    const uint32_t dst = smem_u32(ring + (size_t)s * 2 * TILE);
    mbar_expect_tx(full(s), 2 * bytes);
    bulk_copy(dst, kh + off, bytes, full(s));
    bulk_copy(dst + TILE, vh + off, bytes, full(s));
  };
  int tau_issue = walk.next(tau0);
  if (producer)
    for (int s = 0; s < stages && tau_issue < walk.end; ++s) {
      issue(tau_issue, s);
      tau_issue = walk.next(tau_issue + 1);
    }

  float qr[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      qr[g][d] = g < gn ? to_f(q[(qrow + g) * HD + lane * DPL + d]) * scale
                        : 0.f;
  float m[GT], l[GT], acc[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;
  }
  // the key whose full score a lane ends with: chunk lane % 8, and within
  // the chunk the index the reduce-scatter leaves it (lane bits 3 and 4)
  const int my_key = KC * (lane & 7) + ((lane >> 3) & 1) + 2 * ((lane >> 4) & 1);

  int n = 0;
  for (int tau = walk.next(tau0); tau < walk.end;
       tau = walk.next(tau + 1), ++n) {
    const int s = n % stages;
    const uint32_t par = (n / stages) & 1;
    const int nv = walk.keys(tau);
    mbar_wait(full(s), par);
    const TKV* ks = reinterpret_cast<const TKV*>(ring + (size_t)s * 2 * TILE);
    const TKV* vs = reinterpret_cast<const TKV*>(ring + (size_t)s * 2 * TILE +
                                                  TILE);
    // scores: KC keys at a time; lanes hold disjoint dims
    float sc[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) sc[g] = NEG_INF;
#pragma unroll
    for (int c = 0; c < TK / KC; ++c) {
      if (KC * c < nv) {             // keys past nv are garbage: masked
        float part[KC][GT];
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          float x[DPL];
          load_row<DPL>(ks + (KC * c + kk) * HD + lane * DPL, x);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            float a = 0.f;
#pragma unroll
            for (int d = 0; d < DPL; ++d) a = fmaf(qr[g][d], x[d], a);
            part[kk][g] = a;
          }
        }
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          bool up = lane & 16;
          float v0, v1;
          {
            const float s0 = up ? part[0][g] : part[2][g];
            const float k0 = up ? part[2][g] : part[0][g];
            const float s1 = up ? part[1][g] : part[3][g];
            const float k1 = up ? part[3][g] : part[1][g];
            v0 = k0 + __shfl_xor_sync(0xffffffffu, s0, 16);
            v1 = k1 + __shfl_xor_sync(0xffffffffu, s1, 16);
          }
          up = lane & 8;
          const float sd = up ? v0 : v1;
          float v = (up ? v1 : v0) + __shfl_xor_sync(0xffffffffu, sd, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          if ((lane & 7) == c) sc[g] = v;
        }
      }
    }
    // online softmax, one row at a time across the warp
    const bool live = my_key < nv;
    float corr[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float x = sc[g];
      if (cap != 0.f) x = cap * tanhf(x / cap);
      x = live ? x : NEG_INF;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      // masked probabilities are zeroed explicitly: a row with no live key
      // yet would otherwise see exp(NEG_INF - NEG_INF) == 1
      const float p = live ? expf(x - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[g] = expf(m[g] - m_new);
      l[g] = l[g] * corr[g] + sum;
      m[g] = m_new;
      pbuf[my_key * GT + g] = p;
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[g][d] *= corr[g];
    // P V: the probabilities of a key are a broadcast read
    for (int t0 = 0; t0 < nv; t0 += 4) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int t = t0 + kk;
        if (t < nv) {
          float x[DPL];
          load_row<DPL>(vs + t * HD + lane * DPL, x);
          float p[GT];
          if constexpr (GT % 4 == 0) {
#pragma unroll
            for (int g = 0; g < GT; g += 4) {
              const float4 p4 =
                  *reinterpret_cast<const float4*>(&pbuf[t * GT + g]);
              p[g] = p4.x;
              p[g + 1] = p4.y;
              p[g + 2] = p4.z;
              p[g + 3] = p4.w;
            }
          } else {
#pragma unroll
            for (int g = 0; g < GT; ++g) p[g] = pbuf[t * GT + g];
          }
#pragma unroll
          for (int g = 0; g < GT; ++g)
#pragma unroll
            for (int d = 0; d < DPL; ++d)
              acc[g][d] = fmaf(p[g], x[d], acc[g][d]);
        }
      }
    }
    __syncwarp();                   // pbuf and the stage are consumed
    if (lane == 0) mbar_arrive(empty(s));
    if (producer && tau_issue < walk.end) {
      mbar_wait(empty(s), par);     // every warp of the head is done
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(tau_issue, s);
      tau_issue = walk.next(tau_issue + 1);
    }
  }

  if (n_live == 1) {               // the walk is this range alone
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < gn) {
        const float inv = 1.f / fmaxf(l[g], 1e-37f);
#pragma unroll
        for (int d = 0; d < DPL; ++d)
          o[(qrow + g) * HD + lane * DPL + d] = from_f<TQ>(acc[g][d] * inv);
      }
    }
    return;
  }

  // partial (m, l, acc) of row r of range sp, part = r * n_split + sp: acc
  // at ws[part * HD + d] (16-byte aligned), m at ws[MOFF + part], l at
  // ws[MOFF + NP + part]
  const size_t NP = (size_t)B * K * G * n_split, MOFF = NP * HD;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < gn) {
      const size_t part = (qrow + g) * n_split + sp;
      if (lane == 0) {
        ws[MOFF + part] = m[g];
        ws[MOFF + NP + part] = l[g];
      }
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        ws[part * HD + lane * DPL + d] = acc[g][d];
    }
  }
  __threadfence();                 // this lane's partial, before the ticket
  __syncwarp();
  int* ticket = tickets + ((size_t)b * K + h) * n_gg + gg;
  int drawn = 0;
  if (lane == 0) drawn = atomicAdd(ticket, 1);
  drawn = __shfl_sync(0xffffffffu, drawn, 0);
  if (drawn != n_live - 1) return;
  if (lane == 0) *ticket = 0;      // for the next launch
  __threadfence();
  // lane r takes range r's (m, l) for every row of the group (the ranges
  // past 32 in further rounds); then the acc rows of RB ranges at a time
  // (64 floats a lane), their loads issued before any is used
  constexpr int RB = 64 / (GT * DPL) < 1 ? 1 : (64 / (GT * DPL) > 8 ? 8 : 64 / (GT * DPL));
  float Mrow[GT], Ls[GT], A[GT][DPL], w[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    Ls[g] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) A[g][d] = 0.f;
  }
  for (int r0 = 0; r0 < n_live; r0 += 32) {
    const int nr = min(32, n_live - r0);
    float mr[GT], lr[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const size_t part = (qrow + g) * n_split + r0 + lane;
      const bool ok = g < gn && lane < nr;
      mr[g] = ok ? __ldcg(ws + MOFF + part) : NEG_INF;
      lr[g] = ok ? __ldcg(ws + MOFF + NP + part) : 0.f;
    }
    // the row maxima over every range: the first round takes all of them
    // (n_live <= 32 at the serving shapes); a later round rescales
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = mr[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (r0 == 0) {
        Mrow[g] = mx;
      } else if (mx > Mrow[g]) {
        const float c = expf(Mrow[g] - mx);
        Ls[g] *= c;
#pragma unroll
        for (int d = 0; d < DPL; ++d) A[g][d] *= c;
        Mrow[g] = mx;
      }
      // a range with no live key (m = NEG_INF) has weight 0
      w[g] = mr[g] != NEG_INF ? expf(mr[g] - Mrow[g]) : 0.f;
      Ls[g] = fmaf(lr[g], w[g], Ls[g]);
    }
    for (int r1 = 0; r1 < nr; r1 += RB) {
      float x[RB][GT][DPL];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          if (r1 + i < nr && g < gn)
            load_global(ws + ((qrow + g) * n_split + r0 + r1 + i) * HD +
                            lane * DPL, x[i][g]);
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float wi = __shfl_sync(0xffffffffu, w[g], (r1 + i) & 31);
          if (r1 + i < nr && g < gn)
#pragma unroll
            for (int d = 0; d < DPL; ++d)
              A[g][d] = fmaf(x[i][g][d], wi, A[g][d]);
        }
    }
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < gn) {
      float l = Ls[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      const float inv = 1.f / fmaxf(l, 1e-37f);
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        o[(qrow + g) * HD + lane * DPL + d] = from_f<TQ>(A[g][d] * inv);
    }
  }
}

template <typename TQ, typename TKV, int HD, int GT>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* pos, void* ws, void* tickets, void* o, int B, int K,
           int G, int ps, int pps, int n_pool, int kt, int n_gg, int ggb,
           int tps, int n_split, int stages, int smem, float scale,
           float cap, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<TQ, TKV, HD, GT>;
  // the limit is raised once per instantiation and device (a host call at
  // every launch costs time that a short kernel shows)
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return -1;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const dim3 grid(K / kt * (n_gg / ggb), B, n_split);
  kernel<<<grid, 32 * kt * ggb, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<const int*>(pt),
      static_cast<const int*>(pos), static_cast<float*>(ws),
      static_cast<int*>(tickets), static_cast<TQ*>(o), B, K, G, ps, pps,
      n_pool, kt, n_gg, ggb, tps, n_split, stages, scale, cap);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int HD>
int dispatch_gt(int gt, const void* q, const void* kp, const void* vp,
                const void* pt, const void* pos, void* ws, void* tickets,
                void* o, int B, int K, int G, int ps, int pps, int n_pool,
                int kt, int n_gg, int ggb, int tps, int n_split,
                int stages, int smem, float scale, float cap,
                cudaStream_t st) {
#define PD_LAUNCH(GTV)                                                      \
  return launch<TQ, TKV, HD, GTV>(q, kp, vp, pt, pos, ws, tickets, o, B, K, \
                                  G, ps, pps, n_pool, kt, n_gg, ggb, tps,   \
                                  n_split, stages, smem, scale, cap, st)
  switch (gt) {
    case 1: PD_LAUNCH(1);
    case 2: PD_LAUNCH(2);
    case 4: PD_LAUNCH(4);
    case 8:
      if constexpr (HD < 256) {
        PD_LAUNCH(8);
      }
      return -1;
    default:
      return -1;
  }
#undef PD_LAUNCH
}

template <typename TQ, typename TKV>
int dispatch_hd(int hd, int gt, const void* q, const void* kp,
                const void* vp, const void* pt, const void* pos, void* ws,
                void* tickets, void* o, int B, int K, int G, int ps, int pps,
                int n_pool, int kt, int n_gg, int ggb, int tps,
                int n_split, int stages, int smem, float scale, float cap,
                cudaStream_t st) {
  if (hd == 64)
    return dispatch_gt<TQ, TKV, 64>(gt, q, kp, vp, pt, pos, ws, tickets, o, B,
                                    K, G, ps, pps, n_pool, kt, n_gg, ggb, tps,
                                    n_split, stages, smem, scale, cap, st);
  if (hd == 128)
    return dispatch_gt<TQ, TKV, 128>(gt, q, kp, vp, pt, pos, ws, tickets, o,
                                     B, K, G, ps, pps, n_pool, kt, n_gg, ggb,
                                     tps, n_split, stages, smem, scale, cap,
                                     st);
  if (hd == 256)
    return dispatch_gt<TQ, TKV, 256>(gt, q, kp, vp, pt, pos, ws, tickets, o,
                                     B, K, G, ps, pps, n_pool, kt, n_gg, ggb,
                                     tps, n_split, stages, smem, scale, cap,
                                     st);
  return -1;
}

}  // namespace

// qdt / kvdt: 0 = float32, 1 = bfloat16 (q and o share qdt; float32 q over
// bfloat16 pools is the fp32-compute / bf16-cache configuration).  The
// work decomposition is the caller's (the wrapper's decode_plan, from
// shapes alone): n_gg row groups of at most gt query rows a kv head, kt kv
// heads and ggb row groups a block (at most MAX_WARPS warps), n_split
// ranges of tps tiles of 32 keys, a ring of `stages` tiles a head, and
// smem bytes of dynamic shared memory for the block's layout: kt rings of
// `stages` K and V tiles, kt * ggb per-warp probability buffers of 32 * gt
// floats, then kt * stages full and empty mbarriers.  ws is fp32 scratch
// of B * K * G * n_split * (2 + hd) floats; tickets B * K * n_gg int32
// counters, zero before the first launch (every launch leaves them zero).
// All operands contiguous, pools 16-byte aligned.  Returns 0 when the
// kernel was launched, a CUDA error code when the launch was refused, -1
// for an unsupported shape or type.
extern "C" int paged_decode_fwd(const void* q, const void* kp, const void* vp,
                                const void* pt, const void* pos, void* ws,
                                void* tickets, void* o, int qdt, int kvdt,
                                int B, int K, int G, int hd, int ps, int pps,
                                int n_pool, int kt, int n_gg, int ggb, int gt,
                                int tps, int n_split, int stages, int smem,
                                float scale, float cap, void* stream) {
  const int gr = n_gg > 0 ? (G + n_gg - 1) / n_gg : 0;
  if (B <= 0 || K <= 0 || G <= 0 || ps <= 0 || pps <= 0 || n_pool <= 0 ||
      kt <= 0 || K % kt != 0 || n_gg <= 0 || ggb <= 0 || n_gg % ggb != 0 ||
      kt * ggb > MAX_WARPS || tps <= 0 || stages <= 0 || gr > gt ||
      gr * (n_gg - 1) >= G || smem <= 0 ||
      (long long)n_split * tps < (long long)pps * ((ps + TK - 1) / TK))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qdt == 1 && kvdt == 1)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(
        hd, gt, q, kp, vp, pt, pos, ws, tickets, o, B, K, G, ps, pps, n_pool,
        kt, n_gg, ggb, tps, n_split, stages, smem, scale, cap, st);
  if (qdt == 0 && kvdt == 0)
    return dispatch_hd<float, float>(hd, gt, q, kp, vp, pt, pos, ws, tickets,
                                     o, B, K, G, ps, pps, n_pool, kt, n_gg,
                                     ggb, tps, n_split, stages, smem, scale,
                                     cap, st);
  if (qdt == 0 && kvdt == 1)
    return dispatch_hd<float, __nv_bfloat16>(
        hd, gt, q, kp, vp, pt, pos, ws, tickets, o, B, K, G, ps, pps, n_pool,
        kt, n_gg, ggb, tps, n_split, stages, smem, scale, cap, st);
  return -1;
}
