// Flash attention forward (prefill) for Hopper, sm_90a.
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/flash_attention.py:_flash_kernel (called through
// kernels/ops.py:flash_attention_bshd from models/attention.py).
//
// What it computes: blocked online-softmax attention over the model's
// (B, S, heads, hd) layout.  Query head h of batch row b reads kv head
// h / G (GQA).  Causal and sliding-window masks, a tanh logit softcap
// applied before the mask, fp32 (m, l, acc), output acc / max(l, 1e-37).
// Keys past S are masked, so S need not be a multiple of any tile.
//
// Design: the TPU walked kv blocks as a sequential grid axis with (m, l,
// acc) in VMEM scratch.  Here one thread block owns a 64-row q tile of one
// (b, h) and loops over kv tiles of 64 keys (32 in bf16 at hd 256); that
// loop replaces the grid axis.
// kv tiles beyond the causal frontier or before the window are never
// loaded, and every masked probability is zeroed explicitly.
//
// Two instantiations of that walk:
//
// * bf16 (the serving path): tensor cores through mma.sync m16n8k16 with
//   fp32 accumulation.  4 warps; warp w owns q rows 16w..16w+15 of the tile
//   and keeps its Q fragments, its 16 x 64 score tile, its 16 x hd output
//   accumulator and its rows' (m, l) in registers.  At hd 256 (the local
//   layers of recurrentgemma: 16 q heads over one kv head, window 2048) the
//   accumulator is 128 registers a thread, so the Q tile (32 KB) stays in
//   shared memory behind the K/V stages and each k-step reads its fragment
//   with ldmatrix, and kv tiles are 32 keys (a 16 x 32 score tile): 96 KB
//   of shared memory, two blocks an SM.  K and V tiles are
//   staged in shared memory by cp.async, two stages deep (the next tile
//   loads while this one is used), with a 16-byte-chunk XOR swizzle so the
//   ldmatrix reads are free of bank conflicts.  The probabilities are
//   rounded to bf16 for the P.V product (the plain version keeps fp32 P;
//   the difference is within the stated bf16 tolerance).
// * fp32 (exactness checks): the same walk on the CUDA cores in fp32, 256
//   threads, thread (ty, tx) owning q rows ty + 16 i and keys tx + 16 j
//   (i, j < 4) of the score tile and output dims tx + 16 jj of its rows.
//
// Bound on the card: a causal prefill does about 2 * B * H * S^2 * hd
// FLOPs (two products over half the score matrix); against 989 TFLOP/s
// (bf16 tensor cores, H100 SXM) that is the compute bound, while q, k, v
// and o are read or written once (bytes / 3.35 TB/s).  mma.sync reaches a
// fraction of the wgmma peak; wgmma / TMA and warp specialisation are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BKV = 64;         // keys per kv tile
constexpr int NT = 256;         // threads per block of the fp32 path
constexpr float NEG_INF = -2.0e38f;

// ---------------------------------------------------------------------------
// fp32 path (CUDA cores)
// ---------------------------------------------------------------------------

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + BKV * (HD + 1) + BKV * HD + BQ * (BKV + 1);
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int S,
               int H, int KH, float scale, int causal, int window,
               float cap) {
  constexpr int DJ = HD / 16;               // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;                         // [BQ][HD + 1], scaled
  float* Ks = Qs + BQ * (HD + 1);           // [BKV][HD + 1]
  float* Vs = Ks + BKV * (HD + 1);          // [BKV][HD]
  float* Ps = Vs + BKV * HD;                // [BQ][BKV + 1]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = blockIdx.y * BQ;
  const size_t qstride = (size_t)H * HD, kstride = (size_t)KH * HD;
  const float* qb = q + (size_t)b * S * qstride + (size_t)h * HD;
  const float* kb = k + (size_t)b * S * kstride + (size_t)kh * HD;
  const float* vb = v + (size_t)b * S * kstride + (size_t)kh * HD;
  float* ob = o + (size_t)b * S * qstride + (size_t)h * HD;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx - r * HD, s = q0 + r;
    Qs[r * (HD + 1) + d] =
        s < S ? qb[(size_t)s * qstride + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  // live kv range of this q tile: causal ends at the tile's last row, a
  // window starts at the earliest key its first row can see
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window ? (max(0, q0 - window + 1) / BKV) * BKV : 0;

  for (int t0 = kv_begin; t0 < kv_end; t0 += BKV) {
    __syncthreads();  // Q staged; the previous tile's K, V, P consumed
    for (int idx = tid; idx < BKV * HD; idx += NT) {
      const int r = idx / HD, d = idx - r * HD, t = t0 + r;
      float kk = 0.f, vv = 0.f;
      if (t < S) {
        kk = kb[(size_t)t * kstride + d];
        vv = vb[(size_t)t * kstride + d];
      }
      Ks[r * (HD + 1) + d] = kk;
      Vs[r * HD + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pq = q0 + ty + 16 * i;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pk = t0 + tx + 16 * j;
        bool ok = pk < S;
        if (causal) ok = ok && pk <= pq;
        if (window) ok = ok && pq - pk < window;
        float x = s[i][j];
        if (cap != 0.f) x = cap * tanhf(x / cap);
        s[i][j] = ok ? x : NEG_INF;
        live[j] = ok;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // masked probabilities are zeroed explicitly: a row with no live
        // key yet would otherwise see exp(NEG_INF - NEG_INF) == 1
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(ty + 16 * i) * (BKV + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BKV; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BKV + 1) + t];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float vv = Vs[t * HD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      ob[(size_t)row * qstride + tx + 16 * jj] = acc[i][jj] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path
// ---------------------------------------------------------------------------
constexpr int MMA_THREADS = 128;  // 4 warps, 16 q rows each

// keys per kv tile: 64, or 32 at hd 256, where a thread's 128 output
// accumulators leave no room for a 64-key score tile (32 more registers)
template <int HD>
__host__ __device__ constexpr int kv_tile() {
  return HD > 128 ? 32 : 64;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; src_bytes = 0 writes zeros (rows past S).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A [64][HD] bf16 tile is HD / 8 chunks of 16 bytes per row; chunk c of
// row r lives at chunk c ^ (r & 7), so the 8 rows an ldmatrix reads at one
// logical chunk land in 8 distinct bank groups.
template <int HD>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * (HD / 8) + (chunk ^ (row & 7));
}

template <int HD>
__device__ __forceinline__ void load_kv_tile(
    __nv_bfloat16* ks, __nv_bfloat16* vs, const __nv_bfloat16* kb,
    const __nv_bfloat16* vb, size_t kstride, int t0, int S, int tid) {
  constexpr int CH = HD / 8, KT = kv_tile<HD>();
#pragma unroll
  for (int i = 0; i < KT * CH / MMA_THREADS; ++i) {
    const int idx = tid + i * MMA_THREADS;
    const int r = idx / CH, c = idx - r * CH, t = t0 + r;
    const bool in = t < S;
    const size_t off = in ? (size_t)t * kstride + c * 8 : 0;
    cp_async16(smem_u32(ks + swz<HD>(r, c) * 8), kb + off, in ? 16 : 0);
    cp_async16(smem_u32(vs + swz<HD>(r, c) * 8), vb + off, in ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int S, int H, int KH,
              float scale, int causal, int window, float cap) {
  constexpr int KT = kv_tile<HD>();
  constexpr int KS = HD / 16;      // k-steps of Q.K^T
  constexpr int NKT = KT / 8;     // 8-key score tiles of a kv tile
  constexpr int DT = HD / 8;       // 8-dim output tiles
  // at hd 256 the output accumulator alone is 128 registers a thread, so
  // Q fragments (another 64) stay in shared memory
  constexpr bool Q_SMEM = HD > 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // stage s: K at smem + s * 2 * KT * HD, V right after it; then Q
  // (hd 256 only)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n_qt = gridDim.x;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;   // long tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / (H / KH);
  const size_t qstride = (size_t)H * HD, kstride = (size_t)KH * HD;
  const __nv_bfloat16* qb = q + (size_t)b * S * qstride + (size_t)h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * S * kstride + (size_t)kh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * S * kstride + (size_t)kh * HD;
  __nv_bfloat16* ob = o + (size_t)b * S * qstride + (size_t)h * HD;

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window ? (max(0, q0 - window + 1) / KT) * KT : 0;
  const int n_tiles = (kv_end - kv_begin + KT - 1) / KT;

  if (n_tiles > 0)
    load_kv_tile<HD>(smem, smem + KT * HD, kb, vb, kstride, kv_begin, S,
                     tid);
  // hd 256: the Q tile waits in shared memory behind the two K/V stages
  // and each k-step reads its fragment with ldmatrix (rows past S are
  // zero-filled); it lands with the first K/V tile's group
  __nv_bfloat16* qs = smem + 2 * 2 * KT * HD;
  if constexpr (Q_SMEM) {
    constexpr int CH = HD / 8;
#pragma unroll
    for (int i = 0; i < BQ * CH / MMA_THREADS; ++i) {
      const int idx = tid + i * MMA_THREADS;
      const int r = idx / CH, c = idx - r * CH, s = q0 + r;
      const bool in = s < S;
      cp_async16(smem_u32(qs + swz<HD>(r, c) * 8),
                 qb + (in ? (size_t)s * qstride + c * 8 : 0), in ? 16 : 0);
    }
  }
  cp_async_commit();

  // this warp's two rows per thread: r0 = q0 + 16 warp + g, r1 = r0 + 8
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  uint32_t qf[Q_SMEM ? 1 : KS][4];
  if constexpr (!Q_SMEM) {
    const uint32_t* q0p = reinterpret_cast<const uint32_t*>(
        qb + (size_t)min(r0, S - 1) * qstride);
    const uint32_t* q1p = reinterpret_cast<const uint32_t*>(
        qb + (size_t)min(r1, S - 1) * qstride);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = (16 * ks + 2 * tq) / 2;   // bf16 pair index
      qf[ks][0] = r0 < S ? q0p[c] : 0u;
      qf[ks][1] = r1 < S ? q1p[c] : 0u;
      qf[ks][2] = r0 < S ? q0p[c + 4] : 0u;
      qf[ks][3] = r1 < S ? q1p[c + 4] : 0u;
    }
  }

  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = kv_begin + it * KT;
    if (it + 1 < n_tiles) {
      __nv_bfloat16* nxt = smem + ((it + 1) & 1) * 2 * KT * HD;
      load_kv_tile<HD>(nxt, nxt + KT * HD, kb, vb, kstride, t0 + KT, S,
                       tid);
    }
    cp_async_commit();          // possibly empty: keeps wait_group 1 exact
    cp_async_wait_1();
    __syncthreads();
    const __nv_bfloat16* ks_t = smem + (it & 1) * 2 * KT * HD;
    const __nv_bfloat16* vs_t = ks_t + KT * HD;

    // S = Q K^T for this warp's 16 rows and the tile's KT keys
    float sacc[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t(&qa)[4] = qf[Q_SMEM ? 0 : ks];
      if constexpr (Q_SMEM) {
        // A fragment of rows 16 warp .. +15, dims 16 ks .. +15: matrix m
        // = lane / 8 is rows + 8 (m & 1), dims + 8 (m >> 1)
        const int row = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(qa, smem_u32(qs + swz<HD>(row, ks * 2 + (lane >> 4)) * 8));
      }
#pragma unroll
      for (int np = 0; np < NKT / 2; ++np) {
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int chunk = ks * 2 + ((lane >> 3) & 1);
        uint32_t bfr[4];
        ldmatrix_x4(bfr, smem_u32(ks_t + swz<HD>(key, chunk) * 8));
        mma_bf16(sacc[2 * np], qa, bfr[0], bfr[1]);
        mma_bf16(sacc[2 * np + 1], qa, bfr[2], bfr[3]);
      }
    }

    // scale, softcap, mask; online softmax over the two rows
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int key = t0 + 8 * j + 2 * tq + (e & 1);
        float x = sacc[j][e] * scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);
        bool ok = key < S;
        if (causal) ok = ok && key <= row;
        if (window) ok = ok && row - key < window;
        x = ok ? x : NEG_INF;
        sacc[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sacc[j][e];
        // masked probabilities are zeroed explicitly: a row with no live
        // key yet would otherwise see exp(NEG_INF - NEG_INF) == 1
        const float p = x == NEG_INF ? 0.f : expf(x - (e < 2 ? mn0 : mn1));
        sacc[j][e] = p;
        if (e < 2) s0 += p; else s1 += p;
      }
    }
    l0 = l0 * c0 + s0;      // per-thread partial sums; reduced at the end
    l1 = l1 * c1 + s1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      oacc[dt][0] *= c0;
      oacc[dt][1] *= c0;
      oacc[dt][2] *= c1;
      oacc[dt][3] *= c1;
    }

    // O += P V: the score accumulators of key tiles 2kk, 2kk+1 are the A
    // fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < NKT / 2; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
      pa[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
      pa[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int chunk = dp * 2 + (lane >> 4);
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, smem_u32(vs_t + swz<HD>(key, chunk) * 8));
        mma_bf16(oacc[2 * dp], pa, bfr[0], bfr[1]);
        mma_bf16(oacc[2 * dp + 1], pa, bfr[2], bfr[3]);
      }
    }
    __syncthreads();   // the next iteration refills this stage
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-37f), inv1 = 1.f / fmaxf(l1, 1e-37f);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int d = 8 * dt + 2 * tq;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * qstride + d) =
          pack_bf16(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * qstride + d) =
          pack_bf16(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
  }
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KH, float scale, int causal, int window,
                float cap, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_simt<HD><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KH, scale,
      causal, window, cap);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KH, float scale, int causal, int window,
               float cap, cudaStream_t stream) {
  constexpr int KT = kv_tile<HD>();
  const int smem = (2 * 2 * KT * HD + (HD > 128 ? BQ * HD : 0)) *
                   (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_mma<HD><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, H, KH, scale, causal, window, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, o: (B, S, H, hd); k, v: (B, S, KH,
// hd); all contiguous.  Returns 0 when the kernel was launched, a CUDA
// error code when the launch was refused, -1 for an unsupported shape or
// type.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int S, int H, int KH, int hd, float scale,
                                   int causal, int window, float cap,
                                   void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || window < 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return launch_simt<64>(q, k, v, o, B, S, H, KH, scale, causal,
                                  window, cap, st);
  if (dtype == 0 && hd == 128)
    return launch_simt<128>(q, k, v, o, B, S, H, KH, scale, causal,
                                   window, cap, st);
  if (dtype == 1 && hd == 64)
    return launch_mma<64>(q, k, v, o, B, S, H, KH, scale, causal, window,
                          cap, st);
  if (dtype == 0 && hd == 256)
    return launch_simt<256>(q, k, v, o, B, S, H, KH, scale, causal, window,
                            cap, st);
  if (dtype == 1 && hd == 128)
    return launch_mma<128>(q, k, v, o, B, S, H, KH, scale, causal, window,
                           cap, st);
  if (dtype == 1 && hd == 256)
    return launch_mma<256>(q, k, v, o, B, S, H, KH, scale, causal, window,
                           cap, st);
  return -1;
}
