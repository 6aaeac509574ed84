// RWKV6 WKV backward for Hopper, sm_90a.
//
// Replaces no Pallas kernel: the reference trains RWKV6 by jax.grad through
// the plain jnp src/repro/models/rwkv.py:wkv6_chunked (45).  This is that
// gradient, for the forward kernel csrc/rwkv6_wkv.cu, called through
// kernels/ops.py:wkv6_bwd from the backward of ops.WKV6 (every RWKV layer of
// every training step).
//
// What it computes, per (batch b, head h), with w_t = exp(lw_t), S_t the
// state after step t (S_{-1} = s0) and dS_t the gradient of S_t, from
// dS_{S-1} = ds_fin:
//   dr_t  = (S_{t-1} + u k_t v_t^T) do_t
//   dk_t  = dS_t v_t + u r_t (do_t . v_t)
//   dv_t  = dS_t^T k_t + (r_t . (u (*) k_t)) do_t
//   dlw_t = w_t (*) rowsum(dS_t (*) S_{t-1})
//   du   += r_t (*) k_t (do_t . v_t)
//   dS_{t-1} = diag(w_t) dS_t + r_t do_t^T,      ds0 = dS_{-1}
// r, k, v, do (B, S, H, N) in fp32 or bf16; lw (B, S, H, N) fp32; u (H, N)
// fp32; ckpt (B, H, nseg, N, N) fp32, the states the forward wrote before
// every SEG-th step; ds_fin (B, H, N, N) fp32 or null (zero).  Out: dr, dk,
// dv in the inputs' dtype, rounded once; dlw fp32; du per (b, h, segment)
// (B, H, nseg, N) fp32, which the wrapper sums; ds0 (B, H, N, N) fp32.
// Scratch: dsb (B, H, nseg, N, N) fp32, dS at the last step of every
// segment.
//
// Design: the only sequential dependence of the backward is dS, and only
// from segment to segment, so it runs in two kernels.
//
// Pass 1, wkv6_bwd_dstate, one block per (b, h), walks the segments in
// reverse from G = ds_fin and writes G (dS at the segment's last step) to
// dsb before each update G <- diag(P) G + (r (*) Pex)^T dO, Pex_t the
// product of w over the segment's steps before t and P over all of them:
// one (N x SEG)(SEG x N) tensor-core product a segment.  It is software
// pipelined: the products of one segment, the walk of the next (r (*) Pex,
// each thread a quarter of a channel's steps) and the cp.async loads of
// the ones after it overlap.  ds0 is G after segment 0.
//
// Pass 2, wkv6_bwd_chunks, one block per (b, h, segment): 8,192 blocks at
// rwkv6-7b's training shape instead of 128.  It stages the segment's
// inputs, its checkpoint and its dS in shared memory and computes the
// forward's chunked form transposed, in chunks of L = 16 steps.  With
// Pex_t and Psuf_i the products of w over the chunk's steps before t and
// after i, P_L over the chunk, D(i, t) = prod_{i<s<t} w_s (channel-wise),
// S0 the state before the chunk and dS1 the gradient at its last step:
//   X  = dO S0^T,  Y = V dS1^T,  Z = (k (*) Psuf) dS1,  Bm = dO V^T  (L x L)
//   dr_t  = Pex_t X_t + sum_{i<t} D(i,t) k_i Bm[t][i] + u k_t Bm[t][t]
//   dk_i  = Psuf_i Y_i + sum_{t>i} D(i,t) r_t Bm[t][i] + u r_i Bm[i][i]
//   dv    = Z + A^T dO,  A[t][i] = sum_c r_t k_i D(i,t) (i < t), A[t][t] =
//           r_t . (u (*) k_t): the forward's intra-chunk matrix
//   dlw_t = P_L rowsum(S0 (*) dS1) + sum_{t<s} r_s Pex_s X_s
//           + sum_{i<t} k_i Psuf_i Y_i + sum_{i<t<s} D(i,s) k_i r_s Bm[s][i]
//   dS0   = diag(P_L) dS1 + (r (*) Pex)^T dO
// dlw is rowsum(dS_t (*) S_{t-1}) with both states expanded into the
// chunk's boundary matrices and its steps: every term is a sum of products
// of factors w <= 1 and nothing is subtracted, so it holds its precision at
// any decay (the cumulative-sum identity of r dr - k dk, a difference of
// large sums, loses it at strong decays: tests/test_torch_wkv_bwd.py).
// The pair terms (i < t) split by the chunk's halves of 8 steps: within a
// half by running products of w in the walks; across the halves D(i, t)
// = Psuf_i Pex_t of the halves' own decays, so they are tensor-core
// products too: A's cross block (r (*) Pex)(k (*) Psuf)^T, R = Bm (k (*)
// Psuf) and Q = Bm^T (r (*) Pex), whose rows dr, dk and dlw take.  A first
// walk rebuilds the state before every chunk from the checkpoint (S <-
// diag(P_L) S + (k (*) Psuf)^T V), keeping all of them in shared memory;
// then the chunks are walked in reverse with dS in shared memory, four
// phases between block barriers: the walks (a thread a channel and every
// fourth step) form r (*) Pex, k (*) Psuf and the halves' products and A
// within the halves (summed over channels by warp shuffles); all warps run
// X, Y, Z, Bm and A's cross block; then dv, R, Q, rowsum(S0 (*) dS1) and
// dS's update; then the walks add the pair terms and write dr, dk, dlw.
// Every decay is a product of factors w <= 1: nothing overflows, a strong
// decay underflows to 0 as the step recurrence does, and a step past S
// (loaded as zeros, lw 0) changes nothing.
//
// Precision: each fp32 operand of a product is split into TF32 hi + lo
// (lo.hi + hi.lo + hi.hi); a bf16 operand is exact in TF32 and takes two
// products (one for Bm in bf16).  The products that carry on (dS and S
// across chunks, G across segments) split by rounding (cvt.rna); the ones
// whose result is an output split by truncation (two integer operations,
// 2^-20 relative, as the forward's read-out); Bm's diagonal do_t . v_t,
// which du and the bonus terms of dr and dk take alone and which can
// cancel, is an fp32 dot product on the CUDA cores.  A state's update is summed
// in a fresh accumulator and added with one fp32 fmaf.  No atomics: every
// output element is written once and du's partials are summed by the
// wrapper in a fixed order, so two calls are bit-equal.
//
// Bound on the card: the bytes (r, k, v, do read and dr, dk, dv written in
// the inputs' dtype, lw read and dlw written in fp32, s0, ds_fin and ds0)
// once each, 0.74 GB at B 2, S 4096, H 64, N 64 in bf16, 0.22 ms at 3.35
// TB/s (chip_smoke.py:wkv_bwd_work).  The two passes also read r, lw and dO
// twice, and move the checkpoints and dsb (134 MB each at SEG 64), 1.41 GB
// in all (chip_smoke.py:wkv_bwd_moved).  Pass 1 is held by those bytes on
// 128 SMs; pass 2 by instruction issue at one block an SM (179 KB of
// shared memory in bf16 at N 64): the walks' per-channel pair terms, the
// fragment loads and splits.  PERF.md has the measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 64;   // steps a segment (rwkv6_wkv.SEG)
constexpr int L = 16;     // steps a chunk of pass 2 (one m16 tile)
constexpr int HL = L / 2;  // a half of a chunk
constexpr int NCH = SEG / L;
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// two adjacent outputs (p 4- or 8-byte aligned) in one store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// until at most PENDING of this thread's latest groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo to about 2^-22 relative, both exact TF32 values
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// The same split with hi truncated and lo left for the tensor core to
// truncate: two instructions (no cvt), error below 2^-20 relative.  For the
// operands of products that are outputs, whose error is not carried on.
__device__ __forceinline__ void split_t(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// an operand's TF32 parts: exact (a bf16 value) as it is, else split
template <bool EXACT>
__device__ __forceinline__ void frag(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    split(x, hi, lo);
  }
}

// d += A (16 x 8, row) . B (8 x 8, col), TF32 in, fp32 accumulate.
// A: a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4);
// B: b0 (q, g), b1 (q + 4, g); D: (g, 2q), (g, 2q + 1), (g + 8, 2q),
// (g + 8, 2q + 1); g = lane / 4, q = lane % 4.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += A . B from the operands' TF32 parts: lo.hi + hi.lo + hi.hi, the
// products of an exact operand's (zero) lo left out
template <bool AX, bool BX>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  if constexpr (!AX) mma(d, al, bh[0], bh[1]);
  if constexpr (!BX) mma(d, ah, bl[0], bl[1]);
  mma(d, ah, bh[0], bh[1]);
}

// The same with the main product hi.hi in dh and the corrections in dl.
template <bool AX, bool BX>
__device__ __forceinline__ void mma_split2(float (&dh)[4], float (&dl)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  if constexpr (!AX) mma(dl, al, bh[0], bh[1]);
  if constexpr (!BX) mma(dl, ah, bl[0], bl[1]);
  mma(dh, ah, bh[0], bh[1]);
}

// Two adjacent elements (j, j + 1) of a row as TF32 parts: one 32-bit load
// of two bf16 (exact), or a float2 split.
__device__ __forceinline__ void pair(const __nv_bfloat16* p, uint32_t& h0,
                                     uint32_t& h1, uint32_t& l0,
                                     uint32_t& l1) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
  h0 = x << 16;
  h1 = x & 0xffff0000u;
  l0 = l1 = 0u;
}
__device__ __forceinline__ void pair(const float* p, uint32_t& h0,
                                     uint32_t& h1, uint32_t& l0,
                                     uint32_t& l1) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  split_t(x.x, h0, l0);
  split_t(x.y, h1, l1);
}

// One halving step of reduce_scatter, then the next (compile-time indices
// throughout, so a stays in registers).
template <int H, int M>
__device__ __forceinline__ void halve(float (&a)[M], int lane) {
  if constexpr (H >= 1) {
    const bool up = lane & H;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = up ? a[j] : a[j + H];
      const float keep = up ? a[j + H] : a[j];
      a[j] = keep + __shfl_xor_sync(0xffffffffu, send, H);
    }
    halve<H / 2, M>(a, lane);
  }
}
// Sums a[0 .. 32) of every lane over the warp; lane l ends with the sum of
// a[l].
__device__ __forceinline__ float reduce_scatter(float (&a)[32], int lane) {
  halve<16, 32>(a, lane);
  return a[0];
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// Copies rows [0, n) of a (rows x N) row of the model layout (stride
// `step` elements between rows) into shared memory rows of `ld` elements;
// rows [n, rows) are zeros.  Every thread of the block takes part.
template <typename T, int N>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           size_t step, int rows, int n,
                                           int tid, int nt) {
  constexpr int PIECES = N * (int)sizeof(T) / 16;   // 16-byte pieces a row
  for (int e = tid; e < rows * PIECES; e += nt) {
    const int t = e / PIECES, pc = e - t * PIECES;
    const bool ok = t < n;
    const char* s = reinterpret_cast<const char*>(src + (ok ? t : 0) * step);
    cp_async16(reinterpret_cast<char*>(dst + t * ld) + 16 * pc, s + 16 * pc,
               ok ? 16 : 0);
  }
}

// Shared memory of a pass-2 block, in bytes.  Row strides of N + 8
// elements keep the fragment loads free of bank conflicts.
template <typename TI, int N>
struct Chunks {
  static constexpr int LD = N + 8;
  static constexpr int NW = N / 8;                    // warps
  static constexpr int NT = 32 * NW;
  static constexpr int MT = N / 16;                   // m16 tiles of N
  static constexpr int NG = NW / MT;                  // 2 n groups
  static constexpr int NNT = N / 8 / NG;              // n8 tiles a group
  static constexpr int HP = HL * (HL - 1) / 2 + HL;   // a half's A slots
  static constexpr int NGRP = (2 * HP + 31) / 32;     // 32 slots a group
  static constexpr int IN = SEG * LD * (int)sizeof(TI);
  static constexpr int R = 0, K = R + IN, V = K + IN, DO = V + IN;
  static constexpr int W = DO + IN;                   // w [SEG][LD]
  static constexpr int ST = W + SEG * LD * 4;         // S0 [NCH][N][LD]
  static constexpr int DS = ST + NCH * N * LD * 4;    // dS [N][LD]
  static constexpr int RD = DS + N * LD * 4;          // [L][LD] each
  static constexpr int KD = RD + L * LD * 4;
  static constexpr int LT = L + 4;    // X, Y and R/Q by channel: [N][LT]
  static constexpr int X = KD + L * LD * 4;
  static constexpr int Y = X + N * LT * 4;
  static constexpr int RQ = Y + N * LT * 4;
  static constexpr int BM = RQ + N * LT * 4;          // [L][L + 8]
  static constexpr int AM = BM + L * (L + 8) * 4;     // A [L][L + 8]
  static constexpr int AP = AM + L * (L + 8) * 4;     // [NW][NGRP][32]
  static constexpr int TP = AP + NW * NGRP * 32 * 4;  // [NG][N]
  static constexpr int PH = TP + NG * N * 4;          // [2][N]
  static constexpr int DG = PH + 2 * N * 4;           // [SEG] do_t . v_t
  static constexpr int BYTES = DG + SEG * 4;
  static_assert(BYTES <= SMEM_MAX, "pass 2 shared memory");
  static_assert(NG == 2 && NNT * NG * 8 == N, "warp tiling");
  static_assert(NGRP == 3 && NT == 4 * N && L == 16, "walk parts");
};

// Shared memory of a pass-1 block: a ring of NST stages of (r, lw, dO)
// (loads run NST - 2 segments ahead), r (*) Pex of two segments and the
// walk parts' products of two segments.
template <typename TI, int N>
struct Dstate {
  static constexpr int LD = N + 8;
  static constexpr int NW = N / 8;
  static constexpr int NT = 32 * NW;
  static constexpr int MT = N / 16;
  static constexpr int NNT = N / 16;                  // n8 tiles a warp
  static constexpr int NST = sizeof(TI) == 2 ? 5 : 3;
  static constexpr int IN = SEG * LD * (int)sizeof(TI);
  static constexpr int SR = 0, SLW = IN, SDO = SLW + SEG * LD * 4;
  static constexpr int STAGE = SDO + IN;
  static constexpr int RD = NST * STAGE;              // [2][SEG][LD] fp32
  static constexpr int PT = RD + 2 * SEG * LD * 4;    // [2][4][N]
  static constexpr int BYTES = PT + 2 * 4 * N * 4;
  static_assert(BYTES <= SMEM_MAX, "pass 1 shared memory");
};

// Pass 1: dS at the last step of every segment into dsb, and ds0.
// Warp w owns the m16 tile (channels) w % MT and the value columns of n8
// tiles NNT (w / MT) .. + NNT - 1; G stays in its registers.  Software
// pipelined over the segments (i counts them from the last): while the
// products of segment i update G, the walks form segment i + 1's r (*) Pex
// (each thread a channel's quarter of the steps, its part's product of w
// first, then the parts before it) and the inputs of segments i + 2 ..
// i + NST - 1 load, one cp.async group a segment (an empty one past the
// last).
template <typename TI, int N>
__global__ void __launch_bounds__(Dstate<TI, N>::NT, 1)
wkv6_bwd_dstate(const TI* __restrict__ r, const float* __restrict__ lw,
                const TI* __restrict__ dout, const float* __restrict__ ds_fin,
                float* __restrict__ dsb, float* __restrict__ ds0, int S,
                int H, int nseg) {
  using SM = Dstate<TI, N>;
  constexpr int LD = SM::LD, NT = SM::NT, MT = SM::MT, NNT = SM::NNT;
  constexpr bool EX = sizeof(TI) == 2;
  constexpr int PART = SEG / 4;        // steps a walk thread
  extern __shared__ __align__(16) unsigned char sm[];
  float* rd = reinterpret_cast<float*>(sm + SM::RD);
  float* pt = reinterpret_cast<float*>(sm + SM::PT);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const size_t step = (size_t)H * N;
  const size_t base = (size_t)b * S * step + (size_t)h * N;   // (b, 0, h, 0)
  const int mt = warp % MT, c0 = 16 * mt + g;
  const int j0 = 8 * NNT * (warp / MT) + 2 * q;
  auto stage = [&](int i) { return sm + (i % SM::NST) * SM::STAGE; };

  constexpr int AHEAD = SM::NST - 2;
  auto load = [&](int i) {
    if (i >= nseg) {
      cp_async_commit();
      return;
    }
    const int t0 = (nseg - 1 - i) * SEG, n = min(SEG, S - t0);
    unsigned char* st = stage(i);
    stage_rows<TI, N>(reinterpret_cast<TI*>(st + SM::SR), LD,
                      r + base + (size_t)t0 * step, step, SEG, n, tid, NT);
    stage_rows<float, N>(reinterpret_cast<float*>(st + SM::SLW), LD,
                         lw + base + (size_t)t0 * step, step, SEG, n, tid,
                         NT);
    stage_rows<TI, N>(reinterpret_cast<TI*>(st + SM::SDO), LD,
                      dout + base + (size_t)t0 * step, step, SEG, n, tid,
                      NT);
    cp_async_commit();
  };

  float gs[NNT][4];
  {
    const float* d = ds_fin + (size_t)bh * N * N;
#pragma unroll
    for (int nn = 0; nn < NNT; ++nn) {
      const int j = j0 + 8 * nn;
      gs[nn][0] = ds_fin ? d[(size_t)c0 * N + j] : 0.f;
      gs[nn][1] = ds_fin ? d[(size_t)c0 * N + j + 1] : 0.f;
      gs[nn][2] = ds_fin ? d[(size_t)(c0 + 8) * N + j] : 0.f;
      gs[nn][3] = ds_fin ? d[(size_t)(c0 + 8) * N + j + 1] : 0.f;
    }
  }
  auto write_g = [&](float* out) {
#pragma unroll
    for (int nn = 0; nn < NNT; ++nn) {
      const int j = j0 + 8 * nn;
      *reinterpret_cast<float2*>(&out[(size_t)c0 * N + j]) =
          make_float2(gs[nn][0], gs[nn][1]);
      *reinterpret_cast<float2*>(&out[(size_t)(c0 + 8) * N + j]) =
          make_float2(gs[nn][2], gs[nn][3]);
    }
  };

  // a walk thread: channel wc, steps [PART wp, PART (wp + 1)) of a segment
  const int wc = tid % N, wp = tid / N;
  float w[PART];
  auto walk_a = [&](int i) {          // w and the part's product of it
    const float* slw = reinterpret_cast<const float*>(stage(i) + SM::SLW);
    float p = 1.f;
#pragma unroll
    for (int t = 0; t < PART; ++t) {
      w[t] = expf(slw[(wp * PART + t) * LD + wc]);
      p *= w[t];
    }
    pt[((i & 1) * 4 + wp) * N + wc] = p;
  };
  auto walk_b = [&](int i) {          // r (*) Pex
    const TI* sr = reinterpret_cast<const TI*>(stage(i) + SM::SR);
    float* out = rd + (i & 1) * SEG * LD;
    float p = 1.f;
    for (int pp = 0; pp < wp; ++pp) p *= pt[((i & 1) * 4 + pp) * N + wc];
#pragma unroll
    for (int t = 0; t < PART; ++t) {
      const int row = wp * PART + t;
      out[row * LD + wc] = to_f(sr[row * LD + wc]) * p;
      p *= w[t];
    }
  };

  for (int i = 0; i <= AHEAD; ++i) load(i);
  cp_async_wait<AHEAD>();
  __syncthreads();
  walk_a(0);
  __syncthreads();
  walk_b(0);
  for (int i = 0; i < nseg; ++i) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();   // segment i + 1 landed, segment i's r (*) Pex formed
    load(i + AHEAD + 1);
    if (i + 1 < nseg) walk_a(i + 1);
    write_g(dsb + ((size_t)bh * nseg + nseg - 1 - i) * N * N);
    // G <- diag(P) G + (r (*) Pex)^T dO
    const float* rdi = rd + (i & 1) * SEG * LD;
    const TI* sdo = reinterpret_cast<const TI*>(stage(i) + SM::SDO);
    float upd[NNT][2][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < SEG / 8; ++kk) {
      const int t = 8 * kk + q;
      uint32_t ah[4], al[4];
      split(rdi[t * LD + c0], ah[0], al[0]);
      split(rdi[t * LD + c0 + 8], ah[1], al[1]);
      split(rdi[(t + 4) * LD + c0], ah[2], al[2]);
      split(rdi[(t + 4) * LD + c0 + 8], ah[3], al[3]);
#pragma unroll
      for (int nn = 0; nn < NNT; ++nn) {
        const int j = j0 - 2 * q + 8 * nn + g;
        uint32_t bh2[2], bl2[2];
        frag<EX>(to_f(sdo[t * LD + j]), bh2[0], bl2[0]);
        frag<EX>(to_f(sdo[(t + 4) * LD + j]), bh2[1], bl2[1]);
        mma_split2<false, EX>(upd[nn][0], upd[nn][1], ah, al, bh2, bl2);
      }
    }
    float pa = 1.f, pb = 1.f;
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      pa *= pt[((i & 1) * 4 + pp) * N + c0];
      pb *= pt[((i & 1) * 4 + pp) * N + c0 + 8];
    }
#pragma unroll
    for (int nn = 0; nn < NNT; ++nn) {
      gs[nn][0] = fmaf(pa, gs[nn][0], upd[nn][0][0] + upd[nn][1][0]);
      gs[nn][1] = fmaf(pa, gs[nn][1], upd[nn][0][1] + upd[nn][1][1]);
      gs[nn][2] = fmaf(pb, gs[nn][2], upd[nn][0][2] + upd[nn][1][2]);
      gs[nn][3] = fmaf(pb, gs[nn][3], upd[nn][0][3] + upd[nn][1][3]);
    }
    __syncthreads();   // segment i + 1's part products formed
    if (i + 1 < nseg) walk_b(i + 1);
  }
  write_g(ds0 + (size_t)bh * N * N);
}

// Pass 2: one (b, h, segment).
template <typename TI, int N>
__global__ void __launch_bounds__(Chunks<TI, N>::NT, 1)
wkv6_bwd_chunks(const TI* __restrict__ r, const TI* __restrict__ k,
                const TI* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, const float* __restrict__ ckpt,
                const TI* __restrict__ dout, const float* __restrict__ dsb,
                TI* __restrict__ dr, TI* __restrict__ dk,
                TI* __restrict__ dv, float* __restrict__ dlw,
                float* __restrict__ du_part, int S, int H, int nseg) {
  using SM = Chunks<TI, N>;
  constexpr int LD = SM::LD, NT = SM::NT, NW = SM::NW, MT = SM::MT;
  constexpr int NNT = SM::NNT, NGRP = SM::NGRP, HP = SM::HP;
  constexpr bool EX = sizeof(TI) == 2;
  constexpr int LB = L + 8;          // Bm's and A's row stride
  constexpr int LT = SM::LT;
  extern __shared__ __align__(16) unsigned char sm[];
  TI* sr = reinterpret_cast<TI*>(sm + SM::R);
  TI* sk = reinterpret_cast<TI*>(sm + SM::K);
  TI* sv = reinterpret_cast<TI*>(sm + SM::V);
  TI* sdo = reinterpret_cast<TI*>(sm + SM::DO);
  float* sw = reinterpret_cast<float*>(sm + SM::W);
  float* sst = reinterpret_cast<float*>(sm + SM::ST);
  float* sds = reinterpret_cast<float*>(sm + SM::DS);
  float* srd = reinterpret_cast<float*>(sm + SM::RD);
  float* skd = reinterpret_cast<float*>(sm + SM::KD);
  float* sx = reinterpret_cast<float*>(sm + SM::X);
  float* sy = reinterpret_cast<float*>(sm + SM::Y);
  float* srq = reinterpret_cast<float*>(sm + SM::RQ);
  float* sbm = reinterpret_cast<float*>(sm + SM::BM);
  float* sam = reinterpret_cast<float*>(sm + SM::AM);
  float* sap = reinterpret_cast<float*>(sm + SM::AP);
  float* stp = reinterpret_cast<float*>(sm + SM::TP);
  float* sph = reinterpret_cast<float*>(sm + SM::PH);
  float* sdg = reinterpret_cast<float*>(sm + SM::DG);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x / nseg, sg = blockIdx.x - bh * nseg;
  const int b = bh / H, h = bh - b * H;
  const int t0 = sg * SEG, n = min(SEG, S - t0), nch = (n + L - 1) / L;
  const size_t step = (size_t)H * N;
  const size_t base = ((size_t)b * S + t0) * step + (size_t)h * N;
  // a warp's tiles of an (N x N) product: m16 tile mt, n8 tiles jn0 / 8 ..
  const int mt = warp % MT, m0 = 16 * mt + g;
  const int ng = warp / MT, jn0 = 8 * NNT * ng;
  // a warp's channels (or value columns) of an (L x N) product
  const int cn = 8 * warp + g, cc = 8 * warp + 2 * q;

  // -- stage the segment: first what the rebuild reads, then the rest ------
  const size_t item = ((size_t)bh * nseg + sg) * N * N;
  stage_rows<TI, N>(sk, LD, k + base, step, SEG, n, tid, NT);
  stage_rows<TI, N>(sv, LD, v + base, step, SEG, n, tid, NT);
  stage_rows<float, N>(sw, LD, lw + base, step, SEG, n, tid, NT);
  stage_rows<float, N>(sst, LD, ckpt + item, N, N, N, tid, NT);
  cp_async_commit();
  stage_rows<TI, N>(sr, LD, r + base, step, SEG, n, tid, NT);
  stage_rows<TI, N>(sdo, LD, dout + base, step, SEG, n, tid, NT);
  stage_rows<float, N>(sds, LD, dsb + item, N, N, N, tid, NT);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  for (int e = tid; e < SEG * N; e += NT) {
    const int t = e / N, c = e - t * N;
    sw[t * LD + c] = expf(sw[t * LD + c]);
  }
  __syncthreads();

  // a walk thread: channel c, and the chunk's steps t with t % 4 == part;
  // part p < 3 also forms A's slots [32 p, 32 p + 32) (N 16: two parts a
  // warp)
  const int c = tid % N, part = tid / N;
  const float uc = u[h * N + c];
  const int plo = 32 * warp / N, phi = (32 * warp + 31) / N;

  // k (*) Psuf of each half of the chunk at row r0 (both halves' rows of
  // this thread) and the halves' products of w
  auto walk_k = [&](int r0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float p = 1.f;
#pragma unroll
      for (int t = HL * hh + HL - 1; t >= HL * hh; --t) {
        if ((t & 3) == part) skd[t * LD + c] = to_f(sk[(r0 + t) * LD + c]) * p;
        p *= sw[(r0 + t) * LD + c];
      }
      if (part == 0) sph[hh * N + c] = p;
    }
  };
  // (k (*) Psuf over the chunk)[i][c]: the first half's rows times the
  // second half's product
  auto kd_at = [&](int i, int cx) {
    const float x = skd[i * LD + cx];
    return i < HL ? x * sph[N + cx] : x;
  };

  // -- rebuild the state before every chunk --------------------------------
  for (int ch = 0; ch + 1 < nch; ++ch) {
    walk_k(ch * L);
    __syncthreads();
    // S_{ch+1} = diag(P_L) S_ch + (k (*) Psuf)^T V
    const float* s_in = sst + ch * N * LD;
    float* s_out = sst + (ch + 1) * N * LD;
    float upd[NNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < L / 8; ++kk) {
      const int i = 8 * kk + q;
      uint32_t ah[4], al[4];
      split(kd_at(i, m0), ah[0], al[0]);
      split(kd_at(i, m0 + 8), ah[1], al[1]);
      split(kd_at(i + 4, m0), ah[2], al[2]);
      split(kd_at(i + 4, m0 + 8), ah[3], al[3]);
#pragma unroll
      for (int nn = 0; nn < NNT; ++nn) {
        const int j = jn0 + 8 * nn + g;
        uint32_t bh2[2], bl2[2];
        frag<EX>(to_f(sv[(ch * L + i) * LD + j]), bh2[0], bl2[0]);
        frag<EX>(to_f(sv[(ch * L + i + 4) * LD + j]), bh2[1], bl2[1]);
        mma_split<false, EX>(upd[nn], ah, al, bh2, bl2);
      }
    }
    const float pa = sph[m0] * sph[N + m0];
    const float pb = sph[m0 + 8] * sph[N + m0 + 8];
#pragma unroll
    for (int nn = 0; nn < NNT; ++nn) {
      const int j = jn0 + 8 * nn + 2 * q;
      const float2 xa = *reinterpret_cast<const float2*>(&s_in[m0 * LD + j]);
      const float2 xb =
          *reinterpret_cast<const float2*>(&s_in[(m0 + 8) * LD + j]);
      *reinterpret_cast<float2*>(&s_out[m0 * LD + j]) = make_float2(
          fmaf(pa, xa.x, upd[nn][0]), fmaf(pa, xa.y, upd[nn][1]));
      *reinterpret_cast<float2*>(&s_out[(m0 + 8) * LD + j]) = make_float2(
          fmaf(pb, xb.x, upd[nn][2]), fmaf(pb, xb.y, upd[nn][3]));
    }
    __syncthreads();
  }

  cp_async_wait_all();
  __syncthreads();

  // -- the chunks in reverse -----------------------------------------------
  // Bm's diagonal do_t . v_t of every step of the segment once more, as an
  // fp32 dot product on the CUDA cores (each term rounded once), for the
  // terms of dr, dk and du that take it alone: the split-TF32 product
  // keeps 2^-20 of each term, which a cancelling do_t . v_t shows in du
  // (at S 1 du is r k (do . v)).  Four neighbouring lanes take a step,
  // N / 4 channels each, N steps a pass; rows past n are zeros.  The
  // chunks' first barrier orders it before the walks that read it.
  for (int t = tid >> 2; t < SEG; t += NT / 4) {
    const int c0 = (tid & 3) * (N / 4);
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      d = fmaf(to_f(sdo[t * LD + c0 + j]), to_f(sv[t * LD + c0 + j]), d);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if ((tid & 3) == 0) sdg[t] = d;
  }

  float du = 0.f;
  for (int ch = nch - 1; ch >= 0; --ch) {
    const int r0 = ch * L;
    // (1) walks: r (*) Pex and k (*) Psuf within each half, the halves'
    // products of w, and A within each half
    {
      float ww[L], rr[L], kk[L];
#pragma unroll
      for (int t = 0; t < L; ++t) {
        ww[t] = sw[(r0 + t) * LD + c];
        rr[t] = to_f(sr[(r0 + t) * LD + c]);
        kk[t] = to_f(sk[(r0 + t) * LD + c]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float p = 1.f;
#pragma unroll
        for (int t = HL * hh; t < HL * hh + HL; ++t) {
          if ((t & 3) == part) srd[t * LD + c] = rr[t] * p;
          p *= ww[t];
        }
        if (part == 0) sph[hh * N + c] = p;
        p = 1.f;
#pragma unroll
        for (int t = HL * hh + HL - 1; t >= HL * hh; --t) {
          if ((t & 3) == part) skd[t * LD + c] = kk[t] * p;
          p *= ww[t];
        }
      }
      // A[t][i] within half hh (local t', i' < t') at HP hh + t'(t'-1)/2 +
      // i', the bonus r_t . (u (*) k_t) at HP hh + HL(HL-1)/2 + t'; group
      // grp formed by part grp, summed over a warp's channels
#pragma unroll
      for (int grp = 0; grp < NGRP; ++grp) {
        if (grp != plo && grp != phi) continue;      // warp-uniform
        float a[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) a[e] = 0.f;
        if (grp == part) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int tl = 1; tl < HL; ++tl) {
              float x = rr[HL * hh + tl];
#pragma unroll
              for (int il = tl - 1; il >= 0; --il) {
                const int idx = HP * hh + tl * (tl - 1) / 2 + il;
                if (idx / 32 == grp) a[idx % 32] = x * kk[HL * hh + il];
                x *= ww[HL * hh + il];
              }
            }
#pragma unroll
            for (int tl = 0; tl < HL; ++tl) {
              const int idx = HP * hh + HL * (HL - 1) / 2 + tl, t = HL * hh + tl;
              if (idx / 32 == grp) a[idx % 32] = rr[t] * uc * kk[t];
            }
          }
        }
        sap[(warp * NGRP + grp) * 32 + lane] = reduce_scatter(a, lane);
      }
    }
    __syncthreads();

    // (2) all warps: X = dO S0^T and Y = V dS1^T (channels 8 warp .. + 7),
    // Bm = dO V^T (warps 0 and 1), A across the halves = (r (*) Pex)
    // (k (*) Psuf)^T of the halves' own decays (the last warp), and dv's
    // (k (*) Psuf) dS1 (value columns 8 warp .. + 7), kept in registers.
    // X, Y and Bm take the k index permuted (k q <-> column 2q, q + 4 <->
    // 2q + 1) in both operands.
    float za[2][4] = {};
    {
      const float* s0p = sst + ch * N * LD;
      // main products and their TF32 corrections in separate accumulators
      // (shorter dependent chains), summed at the end
      float xa[2][4] = {}, ya[2][4] = {}, ba[4] = {}, xb[2][4] = {};
#pragma unroll 4
      for (int kk = 0; kk < N / 8; ++kk) {
        const int j = 8 * kk + 2 * q;
        uint32_t dh[4], dl[4], vh[4], vl[4];
        pair(&sdo[(r0 + g) * LD + j], dh[0], dh[2], dl[0], dl[2]);
        pair(&sdo[(r0 + g + 8) * LD + j], dh[1], dh[3], dl[1], dl[3]);
        pair(&sv[(r0 + g) * LD + j], vh[0], vh[2], vl[0], vl[2]);
        pair(&sv[(r0 + g + 8) * LD + j], vh[1], vh[3], vl[1], vl[3]);
        uint32_t sh[2], sl[2], gh[2], gl[2];
        pair(&s0p[cn * LD + j], sh[0], sh[1], sl[0], sl[1]);
        pair(&sds[cn * LD + j], gh[0], gh[1], gl[0], gl[1]);
        mma_split2<EX, false>(xa[0], xa[1], dh, dl, sh, sl);
        mma_split2<EX, false>(ya[0], ya[1], vh, vl, gh, gl);
        if (warp < L / 8) {
          uint32_t wh[2], wl[2];
          pair(&sv[(r0 + 8 * warp + g) * LD + j], wh[0], wh[1], wl[0], wl[1]);
          mma_split<EX, EX>(ba, dh, dl, wh, wl);
        }
        // k index c from here on
        const int cq = 8 * kk + q;
        uint32_t ah[4], al[4], bh2[2], bl2[2];
        split_t(kd_at(g, cq), ah[0], al[0]);
        split_t(kd_at(g + 8, cq), ah[1], al[1]);
        split_t(kd_at(g, cq + 4), ah[2], al[2]);
        split_t(kd_at(g + 8, cq + 4), ah[3], al[3]);
        split_t(sds[cq * LD + cn], bh2[0], bl2[0]);
        split_t(sds[(cq + 4) * LD + cn], bh2[1], bl2[1]);
        mma_split2<false, false>(za[0], za[1], ah, al, bh2, bl2);
        if (warp == NW - 1) {
          // rows t of the second half (D rows g + 8) against columns i of
          // the first
          uint32_t rh[4], rl[4], kh2[2], kl2[2];
          split_t(srd[g * LD + cq], rh[0], rl[0]);
          split_t(srd[(g + 8) * LD + cq], rh[1], rl[1]);
          split_t(srd[g * LD + cq + 4], rh[2], rl[2]);
          split_t(srd[(g + 8) * LD + cq + 4], rh[3], rl[3]);
          split_t(skd[g * LD + cq], kh2[0], kl2[0]);
          split_t(skd[g * LD + cq + 4], kh2[1], kl2[1]);
          mma_split2<false, false>(xb[0], xb[1], rh, rl, kh2, kl2);
        }
      }
      sx[cc * LT + g] = xa[0][0] + xa[1][0];
      sx[(cc + 1) * LT + g] = xa[0][1] + xa[1][1];
      sx[cc * LT + g + 8] = xa[0][2] + xa[1][2];
      sx[(cc + 1) * LT + g + 8] = xa[0][3] + xa[1][3];
      sy[cc * LT + g] = ya[0][0] + ya[1][0];
      sy[(cc + 1) * LT + g] = ya[0][1] + ya[1][1];
      sy[cc * LT + g + 8] = ya[0][2] + ya[1][2];
      sy[(cc + 1) * LT + g + 8] = ya[0][3] + ya[1][3];
      if (warp < L / 8) {
        *reinterpret_cast<float2*>(&sbm[g * LB + cc]) =
            make_float2(ba[0], ba[1]);
        *reinterpret_cast<float2*>(&sbm[(g + 8) * LB + cc]) =
            make_float2(ba[2], ba[3]);
      }
      if (warp == NW - 1) {
        sam[(HL + g) * LB + 2 * q] = xb[0][2] + xb[1][2];
        sam[(HL + g) * LB + 2 * q + 1] = xb[0][3] + xb[1][3];
      }
      // A within the halves (the parts' sums over their warps) and its
      // zeros above the diagonal; the last warp wrote the cross block
      for (int e = tid; e < L * L; e += NT) {
        const int t = e / L, i = e - t * L;
        if (t >= HL && i < HL) continue;
        float x = 0.f;
        if (i <= t) {
          const int hh = t / HL, tl = t - HL * hh, il = i - HL * hh;
          const int idx = HP * hh + (il < tl ? tl * (tl - 1) / 2 + il
                                             : HL * (HL - 1) / 2 + tl);
          const int grp = idx / 32, w0 = grp * N / 32;
#pragma unroll
          for (int wr = 0; wr < (N < 32 ? 1 : N / 32); ++wr)
            x += sap[((w0 + wr) * NGRP + grp) * 32 + idx % 32];
        }
        sam[t * LB + i] = x;
      }
    }
    __syncthreads();      // dS1, Bm and A across the halves complete

    // (3) all warps: dv = ... + A^T dO; R = Bm (k (*) Psuf) (rows of the
    // second half, columns of the first) and Q = Bm^T (r (*) Pex) (rows of
    // the first half), the halves' own decays; rowsum(S0 (*) dS1) by
    // halves of the columns; dS1 <- dS0 = diag(P_L) dS1 + (r (*) Pex)^T dO
    // in place (not needed for chunk 0)
    {
      auto a_at = [&](int t, int i) { return sam[t * LB + i]; };
#pragma unroll
      for (int kk = 0; kk < L / 8; ++kk) {
        const int t = 8 * kk + q;
        uint32_t ah[4], al[4];
        split_t(a_at(t, g), ah[0], al[0]);
        split_t(a_at(t, g + 8), ah[1], al[1]);
        split_t(a_at(t + 4, g), ah[2], al[2]);
        split_t(a_at(t + 4, g + 8), ah[3], al[3]);
        uint32_t bh2[2], bl2[2];
        frag<EX>(to_f(sdo[(r0 + t) * LD + cn]), bh2[0], bl2[0]);
        frag<EX>(to_f(sdo[(r0 + t + 4) * LD + cn]), bh2[1], bl2[1]);
        mma_split<false, EX>(za[1], ah, al, bh2, bl2);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) za[0][e] += za[1][e];
      TI* dvp = dv + base;
      if (r0 + g < n)
        store2(&dvp[(size_t)(r0 + g) * step + cc], za[0][0], za[0][1]);
      if (r0 + g + 8 < n)
        store2(&dvp[(size_t)(r0 + g + 8) * step + cc], za[0][2], za[0][3]);

      // R (D rows g + 8) and Q (D rows g), channels 8 warp .. + 7
      {
        uint32_t ah[4], al[4], bh2[2], bl2[2];
        float ra[2][4] = {}, qa[2][4] = {};
        split_t(sbm[g * LB + q], ah[0], al[0]);
        split_t(sbm[(g + 8) * LB + q], ah[1], al[1]);
        split_t(sbm[g * LB + q + 4], ah[2], al[2]);
        split_t(sbm[(g + 8) * LB + q + 4], ah[3], al[3]);
        split_t(skd[q * LD + cn], bh2[0], bl2[0]);
        split_t(skd[(q + 4) * LD + cn], bh2[1], bl2[1]);
        mma_split2<false, false>(ra[0], ra[1], ah, al, bh2, bl2);
        split_t(sbm[(HL + q) * LB + g], ah[0], al[0]);
        split_t(sbm[(HL + q) * LB + g + 8], ah[1], al[1]);
        split_t(sbm[(HL + q + 4) * LB + g], ah[2], al[2]);
        split_t(sbm[(HL + q + 4) * LB + g + 8], ah[3], al[3]);
        split_t(srd[(HL + q) * LD + cn], bh2[0], bl2[0]);
        split_t(srd[(HL + q + 4) * LD + cn], bh2[1], bl2[1]);
        mma_split2<false, false>(qa[0], qa[1], ah, al, bh2, bl2);
        srq[cc * LT + g + 8] = ra[0][2] + ra[1][2];
        srq[(cc + 1) * LT + g + 8] = ra[0][3] + ra[1][3];
        srq[cc * LT + g] = qa[0][0] + qa[1][0];
        srq[(cc + 1) * LT + g] = qa[0][1] + qa[1][1];
      }

      const float* s0p = sst + ch * N * LD;
      const float pa = sph[m0] * sph[N + m0];
      const float pb = sph[m0 + 8] * sph[N + m0 + 8];
      float ta = 0.f, tb = 0.f;
      float upd[NNT][4] = {};
      if (ch > 0) {
        // r (*) Pex over the chunk: the second half's rows times the first
        // half's product
#pragma unroll
        for (int kk = 0; kk < L / 8; ++kk) {
          const int t = 8 * kk + q;
          const float fa = kk ? sph[m0] : 1.f, fb = kk ? sph[m0 + 8] : 1.f;
          uint32_t ah[4], al[4];
          split(srd[t * LD + m0] * fa, ah[0], al[0]);
          split(srd[t * LD + m0 + 8] * fb, ah[1], al[1]);
          split(srd[(t + 4) * LD + m0] * fa, ah[2], al[2]);
          split(srd[(t + 4) * LD + m0 + 8] * fb, ah[3], al[3]);
#pragma unroll
          for (int nn = 0; nn < NNT; ++nn) {
            const int j = jn0 + 8 * nn + g;
            uint32_t bh2[2], bl2[2];
            frag<EX>(to_f(sdo[(r0 + t) * LD + j]), bh2[0], bl2[0]);
            frag<EX>(to_f(sdo[(r0 + t + 4) * LD + j]), bh2[1], bl2[1]);
            mma_split<false, EX>(upd[nn], ah, al, bh2, bl2);
          }
        }
      }
#pragma unroll
      for (int nn = 0; nn < NNT; ++nn) {
        const int j = jn0 + 8 * nn + 2 * q;
        float2* da = reinterpret_cast<float2*>(&sds[m0 * LD + j]);
        float2* db = reinterpret_cast<float2*>(&sds[(m0 + 8) * LD + j]);
        const float2 ga = *da, gb = *db;
        const float2 sa = *reinterpret_cast<const float2*>(&s0p[m0 * LD + j]);
        const float2 sb =
            *reinterpret_cast<const float2*>(&s0p[(m0 + 8) * LD + j]);
        ta = fmaf(ga.x, sa.x, fmaf(ga.y, sa.y, ta));
        tb = fmaf(gb.x, sb.x, fmaf(gb.y, sb.y, tb));
        if (ch > 0) {
          *da = make_float2(fmaf(pa, ga.x, upd[nn][0]),
                            fmaf(pa, ga.y, upd[nn][1]));
          *db = make_float2(fmaf(pb, gb.x, upd[nn][2]),
                            fmaf(pb, gb.y, upd[nn][3]));
        }
      }
      ta += __shfl_xor_sync(0xffffffffu, ta, 1);
      ta += __shfl_xor_sync(0xffffffffu, ta, 2);
      tb += __shfl_xor_sync(0xffffffffu, tb, 1);
      tb += __shfl_xor_sync(0xffffffffu, tb, 2);
      if (q == 0) {
        stp[ng * N + m0] = ta;
        stp[ng * N + m0 + 8] = tb;
      }
    }
    __syncthreads();

    // (4) walks: dr, dk and dlw of the part's steps, and du
    auto steps = [&](auto pc) {
      constexpr int P = decltype(pc)::value;
      float ww[L], rr[L], kk[L], xx[L], yy[L], rqv[L];
#pragma unroll
      for (int t = 0; t < L; ++t) {
        ww[t] = sw[(r0 + t) * LD + c];
        rr[t] = to_f(sr[(r0 + t) * LD + c]);
        kk[t] = to_f(sk[(r0 + t) * LD + c]);
      }
#pragma unroll
      for (int j = 0; j < L / 4; ++j) {
        const float4 x4 = *reinterpret_cast<const float4*>(&sx[c * LT + 4 * j]);
        const float4 y4 = *reinterpret_cast<const float4*>(&sy[c * LT + 4 * j]);
        const float4 q4 =
            *reinterpret_cast<const float4*>(&srq[c * LT + 4 * j]);
        xx[4 * j] = x4.x, xx[4 * j + 1] = x4.y, xx[4 * j + 2] = x4.z,
        xx[4 * j + 3] = x4.w;
        yy[4 * j] = y4.x, yy[4 * j + 1] = y4.y, yy[4 * j + 2] = y4.z,
        yy[4 * j + 3] = y4.w;
        rqv[4 * j] = q4.x, rqv[4 * j + 1] = q4.y, rqv[4 * j + 2] = q4.z,
        rqv[4 * j + 3] = q4.w;
      }
      const float tt = stp[c] + stp[N + c];
      // over the chunk: the suffix sums of r_s Pex_s X_s and the prefix
      // sums of k_i Psuf_i Y_i; Pex and Psuf of the part's steps
      float rxs[L], kyp[L], pex[L / 4], psuf[L / 4];
      float p = 1.f;
      float rx[L];
#pragma unroll
      for (int t = 0; t < L; ++t) {
        if (t % 4 == P) pex[t / 4] = p;
        rx[t] = rr[t] * p * xx[t];
        p *= ww[t];
      }
      const float pl = p;
      rxs[L - 1] = 0.f;
#pragma unroll
      for (int t = L - 2; t >= 0; --t) rxs[t] = rxs[t + 1] + rx[t + 1];
      p = 1.f;
      float ky[L];
#pragma unroll
      for (int t = L - 1; t >= 0; --t) {
        if (t % 4 == P) psuf[t / 4] = p;
        ky[t] = kk[t] * p * yy[t];
        p *= ww[t];
      }
      kyp[0] = 0.f;
#pragma unroll
      for (int t = 1; t < L; ++t) kyp[t] = kyp[t - 1] + ky[t - 1];
      // across the halves, with the halves' own decays: the prefix sums of
      // the first half's k_i Psuf_i Q_i and Psuf of its part's steps, the
      // suffix sums of the second half's r_s Pex_s R_s and Pex of its
      // part's steps
      float cross[L], psuf0[HL / 4], pex1[HL / 4];
      p = 1.f;
      float kq[HL];
#pragma unroll
      for (int i = HL - 1; i >= 0; --i) {
        if (i % 4 == P) psuf0[i / 4] = p;
        kq[i] = kk[i] * p * rqv[i];
        p *= ww[i];
      }
      cross[0] = 0.f;
#pragma unroll
      for (int t = 1; t < HL; ++t) cross[t] = cross[t - 1] + kq[t - 1];
      p = 1.f;
      float rq[HL];
#pragma unroll
      for (int s = HL; s < L; ++s) {
        if (s % 4 == P) pex1[(s - HL) / 4] = p;
        rq[s - HL] = rr[s] * p * rqv[s];
        p *= ww[s];
      }
      cross[L - 1] = 0.f;
#pragma unroll
      for (int t = L - 2; t >= HL; --t) cross[t] = cross[t + 1] + rq[t + 1 - HL];
#pragma unroll
      for (int m = 0; m < L / 4; ++m) {
        const int t = 4 * m + P, h0 = t < HL ? 0 : HL, h1 = h0 + HL;
        // within the half: alpha_i = D(i, t) k_i (i < t) and beta_s =
        // D(t, s) r_s (s > t), running products of w; Bm's rows as float4
        // loads up to column t
        float alpha[L], brow[L];
        float d = 1.f;
#pragma unroll
        for (int i = t - 1; i >= h0; --i) {
          alpha[i] = d * kk[i];
          d *= ww[i];
        }
        auto bm_row = [&](int s) {
#pragma unroll
          for (int j = h0 / 4; j <= t / 4; ++j) {
            const float4 x = *reinterpret_cast<const float4*>(
                &sbm[s * LB + 4 * j]);
            brow[4 * j] = x.x;
            brow[4 * j + 1] = x.y;
            brow[4 * j + 2] = x.z;
            brow[4 * j + 3] = x.w;
          }
        };
        bm_row(t);
        float gr = fmaf(pex[m], xx[t], uc * kk[t] * sdg[r0 + t]);
#pragma unroll
        for (int i = h0; i < t; ++i) gr = fmaf(alpha[i], brow[i], gr);
        float gk = fmaf(psuf[m], yy[t], uc * rr[t] * sdg[r0 + t]);
        du = fmaf(rr[t] * kk[t], sdg[r0 + t], du);
        float tri = 0.f;
        d = 1.f;
#pragma unroll
        for (int s = t + 1; s < h1; ++s) {
          bm_row(s);
          const float beta = d * rr[s];
          gk = fmaf(beta, brow[t], gk);
          float inner = 0.f;
#pragma unroll
          for (int i = h0; i < t; ++i) inner = fmaf(alpha[i], brow[i], inner);
          tri = fmaf(beta, inner, tri);
          d *= ww[s];
        }
        const float gl =
            fmaf(ww[t], tri, pl * tt + rxs[t] + kyp[t] + cross[t]);
        if (t < HL)            // pairs with the second half
          gk = fmaf(psuf0[m], rqv[t], gk);
        else                   // pairs with the first half
          gr = fmaf(pex1[m - HL / 4], rqv[t], gr);
        if (r0 + t < n) {
          const size_t gi = base + (size_t)(r0 + t) * step + c;
          store(&dr[gi], gr);
          store(&dk[gi], gk);
          dlw[gi] = gl;
        }
      }
    };
    switch (part) {
      case 0: steps(Int<0>{}); break;
      case 1: steps(Int<1>{}); break;
      case 2: steps(Int<2>{}); break;
      default: steps(Int<3>{}); break;
    }
  }
  // du: the parts' sums, in part order
  __syncthreads();        // the last chunk's X is read
  sx[part * N + c] = du;
  __syncthreads();
  if (part == 0)
    du_part[((size_t)bh * nseg + sg) * N + c] =
        sx[c] + sx[N + c] + sx[2 * N + c] + sx[3 * N + c];
}

// Sets a kernel's dynamic shared memory once per device.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return -1;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
}

template <typename TI, int N>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* ckpt, const void* dout,
           const void* ds_fin, void* dr, void* dk, void* dv, void* dlw,
           void* du_part, void* ds0, void* dsb, int B, int S, int H,
           cudaStream_t stream) {
  using P1 = Dstate<TI, N>;
  using P2 = Chunks<TI, N>;
  static bool set1[64] = {}, set2[64] = {};
  int rc = allow_smem(wkv6_bwd_dstate<TI, N>, P1::BYTES, set1);
  if (rc) return rc;
  rc = allow_smem(wkv6_bwd_chunks<TI, N>, P2::BYTES, set2);
  if (rc) return rc;
  const int nseg = (S + SEG - 1) / SEG;
  if ((long long)B * H * nseg > 0x7fffffffLL) return -1;
  wkv6_bwd_dstate<TI, N><<<B * H, P1::NT, P1::BYTES, stream>>>(
      static_cast<const TI*>(r), static_cast<const float*>(lw),
      static_cast<const TI*>(dout), static_cast<const float*>(ds_fin),
      static_cast<float*>(dsb), static_cast<float*>(ds0), S, H, nseg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_chunks<TI, N><<<B * H * nseg, P2::NT, P2::BYTES, stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(ckpt),
      static_cast<const TI*>(dout), static_cast<const float*>(dsb),
      static_cast<TI*>(dr), static_cast<TI*>(dk), static_cast<TI*>(dv),
      static_cast<float*>(dlw), static_cast<float*>(du_part), S, H, nseg);
  return (int)cudaGetLastError();
}

template <typename TI>
int dispatch_n(int N, const void* r, const void* k, const void* v,
               const void* lw, const void* u, const void* ckpt,
               const void* dout, const void* ds_fin, void* dr, void* dk,
               void* dv, void* dlw, void* du_part, void* ds0, void* dsb,
               int B, int S, int H, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<TI, 16>(r, k, v, lw, u, ckpt, dout, ds_fin, dr, dk, dv,
                            dlw, du_part, ds0, dsb, B, S, H, stream);
    case 32:
      return launch<TI, 32>(r, k, v, lw, u, ckpt, dout, ds_fin, dr, dk, dv,
                            dlw, du_part, ds0, dsb, B, S, H, stream);
    case 64:
      return launch<TI, 64>(r, k, v, lw, u, ckpt, dout, ds_fin, dr, dk, dv,
                            dlw, du_part, ds0, dsb, B, S, H, stream);
    default:
      return -1;
  }
}

}  // namespace

// dt: 0 = fp32, 1 = bf16 (r, k, v, do and dr, dk, dv).  All operands
// contiguous and 16-byte aligned (cp.async); ds_fin may be null (a zero
// gradient); seg must be SEG (64), the checkpoints' spacing.  du_part
// (B, H, nseg, N) and dsb (B, H, nseg, N, N) fp32 are written whole.
// Returns 0 when launched, a CUDA error code when a launch was refused, -1
// for an unsupported shape, type or segment.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* lw, const void* u, const void* ckpt,
                        const void* dout, const void* ds_fin, void* dr,
                        void* dk, void* dv, void* dlw, void* du_part,
                        void* ds0, void* dsb, int dt, int B, int S, int H,
                        int N, int seg, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H > 0x7fffffffLL)
    return -1;
  if (seg != SEG) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt == 0)
    return dispatch_n<float>(N, r, k, v, lw, u, ckpt, dout, ds_fin, dr, dk,
                             dv, dlw, du_part, ds0, dsb, B, S, H, st);
  if (dt == 1)
    return dispatch_n<__nv_bfloat16>(N, r, k, v, lw, u, ckpt, dout, ds_fin,
                                     dr, dk, dv, dlw, du_part, ds0, dsb, B, S,
                                     H, st);
  return -1;
}
