// Flash attention backward for Hopper, sm_90a.
//
// The gradient of the reference's full-mode attention,
// src/repro/models/attention.py:flash_attention_jnp, as jax.grad
// differentiates it when the reference trains (the reference has no
// Pallas backward: src/repro/kernels/ defines no custom_vjp).  The forward
// it belongs to is csrc/flash_attention.cu, which writes the softmax
// log-sum-exp this file reads.
//
// What it computes, over the model's (B, S, heads, hd) layout with GQA
// (kv head = q head / G), from q, k, v, o, lse (B, H, S) fp32 and dO:
//
//   P  = exp(s - lse) on live pairs, s = scale q.k (or cap tanh(scale q.k
//        / cap) under a softcap), 0 on masked pairs
//   D  = rowsum(dO o)                                  (fp32, a first pass)
//   dV = P^T dO                      summed over the G q heads of a kv head
//   dS = P (dO V^T - D)              times 1 - tanh^2 under a softcap
//   dQ = scale dS K,  dK = scale dS^T Q                (summed over G too)
//
// Causal and sliding-window masks; keys and rows past S are masked and
// nothing is written past S.  fp32 accumulators; each output is written
// once in the input's type.
//
// Design (simple first; TMA and wgmma are later work).  Three launches:
//
// * flash_bwd_delta: D, one warp a (b, s, h) row.
// * dK/dV: a block of 4 warps owns (b, kv head, 64-key tile); each warp 16
//   keys.  It walks the G q heads of its group and, for each, the q tiles
//   from the causal frontier on (to the window's end), recomputing S^T and
//   P^T for its keys, and keeps dK and dV in registers across the whole
//   walk, so the sum over the group needs no atomics.
// * dQ: a block of 4 warps owns (b, q head, 64-row q tile) and walks the kv
//   tiles up to the causal frontier.
//
// No atomics anywhere: the result is bit-equal from call to call.  In bf16
// the products are mma.sync m16n8k16 (bf16 in, fp32 accumulate), operands
// staged in padded shared memory (row pitch hd + 8, so a quad's fragment
// loads hit distinct banks); P and dS are rounded to bf16 as the A
// operands of dV += P^T dO and dK += dS^T Q, dQ += dS K.  fp32 runs the
// same walks on the CUDA cores, a thread owning 4 x 4 score elements (the
// exact path the card's parity checks use).
//
// Bound on the card: 10 hd FLOPs per live (q, k) pair (S^T and dP^T
// recomputed, dV, dK and dQ: five products of 2 hd each; the dQ kernel's
// second S and dP are extra work the design spends, not counted) against
// 989 TFLOP/s in bf16 (H100 SXM tensor cores); q, k, v, o, dO read and dq,
// dk, dv written once against 3.35 TB/s.  At the training shapes the
// operations bound.  mma.sync reaches a fraction of wgmma's rate and the
// dQ kernel recomputes S and dP, so this design sits well above the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// D = rowsum(dO o): one warp a row of hd elements
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int rows, int S, int H, int hd) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);   // (b * S + s) * H + h
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* op = o + (size_t)row * hd;
  const T* dp = dout + (size_t)row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(op[d]), to_f(dp[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, bs = row / H, s = bs % S, b = bs / S;
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// Whether query position pq may see key position pk.
__device__ __forceinline__ bool live_pair(int pq, int pk, int S, int causal,
                                          int window) {
  bool ok = pq < S && pk < S;
  if (causal) ok = ok && pk <= pq;
  if (window) ok = ok && pq - pk < window;
  return ok;
}

// ---------------------------------------------------------------------------
// bf16 path: mma.sync m16n8k16
// ---------------------------------------------------------------------------
constexpr int MMA_THREADS = 128;   // 4 warps, 16 rows of the tile each
constexpr int MMA_ROWS = 64;       // the tile a block owns (keys or q rows)

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The fragments, for lane = 4 g + t: A (16 x 16, row-major rows r0..) holds
// (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..); B (16 x 8) holds
// (k 2t..2t+1, n g) and (k 2t+8.., n g); C (16 x 8) holds (g, 2t..2t+1)
// and (g+8, 2t..2t+1).
//
// A from X[r][k] (pitch ld), rows r0.., k columns k0..
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* x,
                                       int ld, int r0, int k0, int g, int t) {
  const bf16* p = x + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}
// B(k, n) = Y[n][k]: the product's k runs along Y's rows (pairs in a word)
__device__ __forceinline__ void load_b_nk(uint32_t& b0, uint32_t& b1,
                                          const bf16* y, int ld, int n0,
                                          int k0, int g, int t) {
  const bf16* p = y + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}
// B(k, n) = Z[k][n]: two 16-bit loads a word
__device__ __forceinline__ void load_b_kn(uint32_t& b0, uint32_t& b1,
                                          const bf16* z, int ld, int k0,
                                          int n0, int g, int t) {
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(z) + (k0 + 2 * t) * ld + n0 + g;
  b0 = (uint32_t)p[0] | ((uint32_t)p[ld] << 16);
  b1 = (uint32_t)p[8 * ld] | ((uint32_t)p[9 * ld] << 16);
}
// The C fragments of n-tiles 2 kk and 2 kk + 1, rounded to bf16, are the A
// fragment of k-step kk.
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[NT][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Rows row0 .. row0 + ROWS - 1 of a (b, S, heads, HD) head slice ``src``
// (row pitch ``stride`` elements) into X[ROWS][HD + 8], 16 bytes a thread;
// rows past S are zeros.
template <int HD, int ROWS, int NTHREADS>
__device__ __forceinline__ void stage_rows(bf16* x, const bf16* src,
                                           size_t stride, int row0, int S) {
  constexpr int CHUNKS = HD / 8;          // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = i - r * CHUNKS, s = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (s < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)s * stride + 8 * c);
    *reinterpret_cast<uint4*>(x + r * (HD + 8) + 8 * c) = val;
  }
}

template <int HD, int BQ>
struct DkdvSmem {
  static constexpr int LD = HD + 8;
  static constexpr int BYTES =
      (2 * MMA_ROWS * LD + 2 * BQ * LD) * 2 + 2 * BQ * 4;
};

// dK, dV of 64 keys of one (b, kv head): warp w owns keys 16 w .. 16 w + 15;
// per (q head of the group, q tile of BQ rows): S^T = K Q^T, P^T, dV +=
// P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q.
template <int HD, int BQ, bool CAP>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int S, int H, int KH, float scale,
                   int causal, int window, float cap) {
  constexpr int LD = HD + 8, NQ = BQ / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + MMA_ROWS * LD;
  bf16* Qs = Vs + MMA_ROWS * LD;
  bf16* Os = Qs + BQ * LD;                  // dO
  float* Ls = reinterpret_cast<float*>(Os + BQ * LD);
  float* Ds = Ls + BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = H / KH;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int k0 = blockIdx.x * MMA_ROWS;
  const size_t qstride = (size_t)H * HD, kstride = (size_t)KH * HD;
  const size_t kv_off = (size_t)b * S * kstride + (size_t)kh * HD;

  stage_rows<HD, MMA_ROWS, MMA_THREADS>(Ks, k + kv_off, kstride, k0, S);
  stage_rows<HD, MMA_ROWS, MMA_THREADS>(Vs, v + kv_off, kstride, k0, S);

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const int key_r = k0 + 16 * warp + g;     // this thread's keys: +0, +8
  const int q_first = causal ? k0 : 0;
  const int q_end = window ? min(S, k0 + MMA_ROWS - 1 + window) : S;
  const float inv_cap = CAP ? 1.f / cap : 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const size_t q_off = (size_t)b * S * qstride + (size_t)h * HD;
    const float* lse_h = lse + ((size_t)b * H + h) * S;
    const float* d_h = delta + ((size_t)b * H + h) * S;
    for (int q0 = (q_first / BQ) * BQ; q0 < q_end; q0 += BQ) {
      __syncthreads();                      // the last tile is consumed
      stage_rows<HD, BQ, MMA_THREADS>(Qs, q + q_off, qstride, q0, S);
      stage_rows<HD, BQ, MMA_THREADS>(Os, dout + q_off, qstride, q0, S);
      for (int i = threadIdx.x; i < BQ; i += MMA_THREADS) {
        const int s = q0 + i;
        Ls[i] = s < S ? lse_h[s] : 0.f;
        Ds[i] = s < S ? d_h[s] : 0.f;
      }
      __syncthreads();

      // S^T (16 keys x BQ queries a warp)
      float p[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        load_a(a, Ks, LD, 16 * warp, 16 * kk, g, t);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          uint32_t b0, b1;
          load_b_nk(b0, b1, Qs, LD, 8 * j, 16 * kk, g, t);
          mma_bf16(p[j], a, b0, b1);
        }
      }
      // P^T; under a softcap keep 1 - tanh^2 for dS
      float dcap[CAP ? NQ : 1][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          const int key = key_r + 8 * (e >> 1);
          float x = p[j][e] * scale;
          if constexpr (CAP) {
            const float th = tanhf(x * inv_cap);
            x = cap * th;
            dcap[j][e] = 1.f - th * th;
          }
          p[j][e] = live_pair(q0 + qi, key, S, causal, window)
                        ? expf(x - Ls[qi])
                        : 0.f;
        }
      // dV += P^T dO
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t a[4];
        acc_to_a<NQ>(a, p, kk);
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          uint32_t b0, b1;
          load_b_kn(b0, b1, Os, LD, 16 * kk, 8 * j, g, t);
          mma_bf16(dv_acc[j], a, b0, b1);
        }
      }
      // dP^T = V dO^T
      float ds[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        load_a(a, Vs, LD, 16 * warp, 16 * kk, g, t);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          uint32_t b0, b1;
          load_b_nk(b0, b1, Os, LD, 8 * j, 16 * kk, g, t);
          mma_bf16(ds[j], a, b0, b1);
        }
      }
      // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          float x = p[j][e] * (ds[j][e] - Ds[qi]);
          if constexpr (CAP) x *= dcap[j][e];
          ds[j][e] = x;
        }
      // dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t a[4];
        acc_to_a<NQ>(a, ds, kk);
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          uint32_t b0, b1;
          load_b_kn(b0, b1, Qs, LD, 16 * kk, 8 * j, g, t);
          mma_bf16(dk_acc[j], a, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = key_r + 8 * rr;
    if (key >= S) continue;
    bf16* dkp = dk + kv_off + (size_t)key * kstride + 2 * t;
    bf16* dvp = dv + kv_off + (size_t)key * kstride + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(dkp + 8 * j) =
          pack_bf16(dk_acc[j][2 * rr] * scale, dk_acc[j][2 * rr + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvp + 8 * j) =
          pack_bf16(dv_acc[j][2 * rr], dv_acc[j][2 * rr + 1]);
    }
  }
}

template <int HD>
struct DqSmem {
  static constexpr int LD = HD + 8;
  static constexpr int BYTES = 4 * MMA_ROWS * LD * 2;
};

// dQ of 64 rows of one (b, q head): warp w owns rows 16 w .. 16 w + 15;
// per 64-key tile: S = Q K^T, P, dP = dO V^T, dS = P (dP - D), dQ += dS K.
template <int HD, bool CAP>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int S, int H, int KH, float scale, int causal, int window,
                 float cap) {
  constexpr int LD = HD + 8, BK = MMA_ROWS, NK = BK / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + MMA_ROWS * LD;            // dO
  bf16* Ks = Os + MMA_ROWS * LD;
  bf16* Vs = Ks + BK * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / KH);
  const int q0 = blockIdx.x * MMA_ROWS;
  const size_t qstride = (size_t)H * HD, kstride = (size_t)KH * HD;
  const size_t q_off = (size_t)b * S * qstride + (size_t)h * HD;
  const size_t kv_off = (size_t)b * S * kstride + (size_t)kh * HD;

  stage_rows<HD, MMA_ROWS, MMA_THREADS>(Qs, q + q_off, qstride, q0, S);
  stage_rows<HD, MMA_ROWS, MMA_THREADS>(Os, dout + q_off, qstride, q0, S);

  const int row_r = q0 + 16 * warp + g;     // this thread's rows: +0, +8
  float lse_r[2], d_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int s = row_r + 8 * rr;
    const size_t i = ((size_t)b * H + h) * S + s;
    lse_r[rr] = s < S ? lse[i] : 0.f;
    d_r[rr] = s < S ? delta[i] : 0.f;
  }

  float dq_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  const int k_first = window ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(S, q0 + MMA_ROWS) : S;
  const float inv_cap = CAP ? 1.f / cap : 0.f;

  for (int t0 = (k_first / BK) * BK; t0 < k_end; t0 += BK) {
    __syncthreads();                        // the last tile is consumed
    stage_rows<HD, BK, MMA_THREADS>(Ks, k + kv_off, kstride, t0, S);
    stage_rows<HD, BK, MMA_THREADS>(Vs, v + kv_off, kstride, t0, S);
    __syncthreads();

    float p[NK][4], ds[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = ds[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], c[4];
      load_a(a, Qs, LD, 16 * warp, 16 * kk, g, t);
      load_a(c, Os, LD, 16 * warp, 16 * kk, g, t);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t b0, b1;
        load_b_nk(b0, b1, Ks, LD, 8 * j, 16 * kk, g, t);
        mma_bf16(p[j], a, b0, b1);          // S = Q K^T
        load_b_nk(b0, b1, Vs, LD, 8 * j, 16 * kk, g, t);
        mma_bf16(ds[j], c, b0, b1);         // dP = dO V^T
      }
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const int key = t0 + 8 * j + 2 * t + (e & 1);
        float x = p[j][e] * scale, dc = 1.f;
        if constexpr (CAP) {
          const float th = tanhf(x * inv_cap);
          x = cap * th;
          dc = 1.f - th * th;
        }
        const float pp = live_pair(row_r + 8 * rr, key, S, causal, window)
                             ? expf(x - lse_r[rr])
                             : 0.f;
        ds[j][e] = pp * (ds[j][e] - d_r[rr]) * dc;
      }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a<NK>(a, ds, kk);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        uint32_t b0, b1;
        load_b_kn(b0, b1, Ks, LD, 16 * kk, 8 * j, g, t);
        mma_bf16(dq_acc[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int s = row_r + 8 * rr;
    if (s >= S) continue;
    bf16* dqp = dq + q_off + (size_t)s * qstride + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(dqp + 8 * j) =
          pack_bf16(dq_acc[j][2 * rr] * scale, dq_acc[j][2 * rr + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// fp32 path (CUDA cores): 256 threads, thread (ty, tx) owning rows ty + 16 i
// and columns tx + 16 j (i, j < 4) of a 64 x 64 score tile, and output dims
// tx + 16 jj of its rows.
// ---------------------------------------------------------------------------
constexpr int SIMT_THREADS = 256;
constexpr int ST = 64;                     // tile rows and columns

template <int HD>
__device__ __forceinline__ void stage_f32(float* x, const float* src,
                                          size_t stride, int row0, int S) {
  for (int i = threadIdx.x; i < ST * HD; i += SIMT_THREADS) {
    const int r = i / HD, d = i - r * HD, s = row0 + r;
    x[r * (HD + 1) + d] = s < S ? src[(size_t)s * stride + d] : 0.f;
  }
}

// c[i][j] = sum_d X[ty + 16 i][d] Y[tx + 16 j][d] over two staged tiles
template <int HD>
__device__ __forceinline__ void tile_dot(float (&c)[4][4], const float* x,
                                         const float* y, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float xv[4], yv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = x[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) yv[j] = y[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(xv[i], yv[j], c[i][j]);
  }
}

// acc[i][jj] += sum_c P[ty + 16 i][c] Z[c][tx + 16 jj]
template <int HD>
__device__ __forceinline__ void tile_acc(float (&acc)[4][HD / 16],
                                         const float* p, const float* z,
                                         int tx, int ty) {
#pragma unroll 4
  for (int c = 0; c < ST; ++c) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * (ST + 1) + c];
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      const float zv = z[c * (HD + 1) + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], zv, acc[i][jj]);
    }
  }
}

template <int HD>
constexpr int simt_smem_bytes() {
  return (4 * ST * (HD + 1) + ST * (ST + 1) + 2 * ST) * 4;
}

template <int HD>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_bwd_dkdv_simt(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int S, int H, int KH,
                    float scale, int causal, int window, float cap) {
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                         // [ST][HD + 1]
  float* Vs = Ks + ST * (HD + 1);
  float* Qs = Vs + ST * (HD + 1);
  float* Os = Qs + ST * (HD + 1);           // dO
  float* Ps = Os + ST * (HD + 1);           // [keys][queries]: P^T, then dS^T
  float* Ls = Ps + ST * (ST + 1);
  float* Ds = Ls + ST;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int G = H / KH;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int k0 = blockIdx.x * ST;
  const size_t qstride = (size_t)H * HD, kstride = (size_t)KH * HD;
  const size_t kv_off = (size_t)b * S * kstride + (size_t)kh * HD;
  stage_f32<HD>(Ks, k + kv_off, kstride, k0, S);
  stage_f32<HD>(Vs, v + kv_off, kstride, k0, S);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;

  const int q_first = causal ? k0 : 0;
  const int q_end = window ? min(S, k0 + ST - 1 + window) : S;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const size_t q_off = (size_t)b * S * qstride + (size_t)h * HD;
    const float* lse_h = lse + ((size_t)b * H + h) * S;
    const float* d_h = delta + ((size_t)b * H + h) * S;
    for (int q0 = (q_first / ST) * ST; q0 < q_end; q0 += ST) {
      __syncthreads();
      stage_f32<HD>(Qs, q + q_off, qstride, q0, S);
      stage_f32<HD>(Os, dout + q_off, qstride, q0, S);
      for (int i = tid; i < ST; i += SIMT_THREADS) {
        Ls[i] = q0 + i < S ? lse_h[q0 + i] : 0.f;
        Ds[i] = q0 + i < S ? d_h[q0 + i] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<HD>(s, Ks, Qs, tx, ty);      // S^T: keys ty.., queries tx..
      tile_dot<HD>(dp, Vs, Os, tx, ty);     // dP^T
      float ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx + 16 * j;
          float x = s[i][j] * scale, dc = 1.f;
          if (cap != 0.f) {
            const float th = tanhf(x / cap);
            x = cap * th;
            dc = 1.f - th * th;
          }
          const float p =
              live_pair(q0 + qi, k0 + ty + 16 * i, S, causal, window)
                  ? expf(x - Ls[qi])
                  : 0.f;
          Ps[(ty + 16 * i) * (ST + 1) + qi] = p;
          ds[i][j] = p * (dp[i][j] - Ds[qi]) * dc;
        }
      __syncthreads();
      tile_acc<HD>(dv_acc, Ps, Os, tx, ty);  // dV += P^T dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(ty + 16 * i) * (ST + 1) + tx + 16 * j] = ds[i][j];
      __syncthreads();
      tile_acc<HD>(dk_acc, Ps, Qs, tx, ty);  // dK += dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= S) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const size_t o = kv_off + (size_t)key * kstride + tx + 16 * jj;
      dk[o] = dk_acc[i][jj] * scale;
      dv[o] = dv_acc[i][jj];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_bwd_dq_simt(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int S, int H, int KH, float scale, int causal, int window,
                  float cap) {
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                         // [ST][HD + 1]
  float* Os = Qs + ST * (HD + 1);           // dO
  float* Ks = Os + ST * (HD + 1);
  float* Vs = Ks + ST * (HD + 1);
  float* Ps = Vs + ST * (HD + 1);           // [queries][keys]: dS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / KH);
  const int q0 = blockIdx.x * ST;
  const size_t qstride = (size_t)H * HD, kstride = (size_t)KH * HD;
  const size_t q_off = (size_t)b * S * qstride + (size_t)h * HD;
  const size_t kv_off = (size_t)b * S * kstride + (size_t)kh * HD;
  stage_f32<HD>(Qs, q + q_off, qstride, q0, S);
  stage_f32<HD>(Os, dout + q_off, qstride, q0, S);

  float lse_r[4], d_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    const size_t idx = ((size_t)b * H + h) * S + s;
    lse_r[i] = s < S ? lse[idx] : 0.f;
    d_r[i] = s < S ? delta[idx] : 0.f;
  }
  float dq_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dq_acc[i][jj] = 0.f;

  const int k_first = window ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(S, q0 + ST) : S;
  for (int t0 = (k_first / ST) * ST; t0 < k_end; t0 += ST) {
    __syncthreads();
    stage_f32<HD>(Ks, k + kv_off, kstride, t0, S);
    stage_f32<HD>(Vs, v + kv_off, kstride, t0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HD>(s, Qs, Ks, tx, ty);        // S: rows ty.., keys tx..
    tile_dot<HD>(dp, Os, Vs, tx, ty);       // dP
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale, dc = 1.f;
        if (cap != 0.f) {
          const float th = tanhf(x / cap);
          x = cap * th;
          dc = 1.f - th * th;
        }
        const float p =
            live_pair(q0 + ty + 16 * i, t0 + tx + 16 * j, S, causal, window)
                ? expf(x - lse_r[i])
                : 0.f;
        Ps[(ty + 16 * i) * (ST + 1) + tx + 16 * j] =
            p * (dp[i][j] - d_r[i]) * dc;
      }
    __syncthreads();
    tile_acc<HD>(dq_acc, Ps, Ks, tx, ty);   // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      dq[q_off + (size_t)s * qstride + tx + 16 * jj] = dq_acc[i][jj] * scale;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B, int S,
                 int H, int hd, cudaStream_t st) {
  const int rows = B * S * H;
  flash_bwd_delta<T><<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, S,
      H, hd);
  return (int)cudaGetLastError();
}

template <int HD, int BQ, bool CAP>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int B, int S, int H, int KH, float scale, int causal,
               int window, float cap, cudaStream_t st) {
  const int kv_bytes = DkdvSmem<HD, BQ>::BYTES, q_bytes = DqSmem<HD>::BYTES;
  auto dkdv = flash_bwd_dkdv_mma<HD, BQ, CAP>;
  auto dqk = flash_bwd_dq_mma<HD, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (S + MMA_ROWS - 1) / MMA_ROWS;
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v),
             *op = static_cast<const bf16*>(dout);
  dkdv<<<dim3(tiles, B * KH), MMA_THREADS, kv_bytes, st>>>(
      qp, kp, vp, op, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, KH, scale, causal, window, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3(tiles, B * H), MMA_THREADS, q_bytes, st>>>(
      qp, kp, vp, op, lse, delta, static_cast<bf16*>(dq), S, H, KH, scale,
      causal, window, cap);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, void* dk,
                void* dv, int B, int S, int H, int KH, float scale,
                int causal, int window, float cap, cudaStream_t st) {
  const int bytes = simt_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_simt<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_simt<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (S + ST - 1) / ST;
  const float *qp = static_cast<const float*>(q),
              *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v),
              *op = static_cast<const float*>(dout);
  flash_bwd_dkdv_simt<HD><<<dim3(tiles, B * KH), SIMT_THREADS, bytes, st>>>(
      qp, kp, vp, op, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, KH, scale, causal, window, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_simt<HD><<<dim3(tiles, B * H), SIMT_THREADS, bytes, st>>>(
      qp, kp, vp, op, lse, delta, static_cast<float*>(dq), S, H, KH, scale,
      causal, window, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout, dq: (B, S, H, hd); k, v,
// dk, dv: (B, S, KH, hd); lse: (B, H, S) fp32 (natural log); delta: (B, H,
// S) fp32 scratch that this call fills.  All contiguous; bf16 operands
// 16-byte aligned.  Returns 0 when every kernel was launched, a CUDA error
// code when a launch was refused, -1 for an unsupported shape or type.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* lse,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* delta, int dtype, int B,
                                   int S, int H, int KH, int hd, float scale,
                                   int causal, int window, float cap,
                                   void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || window < 0) return -1;
  if (hd != 64 && hd != 128) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  int rc = dtype == 1 ? launch_delta<bf16>(o, dout, dp, B, S, H, hd, st)
                      : launch_delta<float>(o, dout, dp, B, S, H, hd, st);
  if (rc) return rc;
  const bool c = cap != 0.f;
  if (dtype == 0)
    return hd == 64
               ? launch_simt<64>(q, k, v, dout, lp, dp, dq, dk, dv, B, S, H,
                                 KH, scale, causal, window, cap, st)
               : launch_simt<128>(q, k, v, dout, lp, dp, dq, dk, dv, B, S, H,
                                  KH, scale, causal, window, cap, st);
  if (hd == 64)
    return c ? launch_mma<64, 64, true>(q, k, v, dout, lp, dp, dq, dk, dv, B,
                                        S, H, KH, scale, causal, window, cap,
                                        st)
             : launch_mma<64, 64, false>(q, k, v, dout, lp, dp, dq, dk, dv,
                                         B, S, H, KH, scale, causal, window,
                                         cap, st);
  return c ? launch_mma<128, 32, true>(q, k, v, dout, lp, dp, dq, dk, dv, B, S,
                                       H, KH, scale, causal, window, cap, st)
           : launch_mma<128, 32, false>(q, k, v, dout, lp, dp, dq, dk, dv, B,
                                        S, H, KH, scale, causal, window, cap,
                                        st);
}
