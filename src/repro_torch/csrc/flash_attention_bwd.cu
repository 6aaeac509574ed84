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
//   D  = rowsum(dO o)                                               (fp32)
//   dV = P^T dO                      summed over the G q heads of a kv head
//   dS = P (dO V^T - D)              times 1 - tanh^2 under a softcap
//   dQ = scale dS K,  dK = scale dS^T Q                (summed over G too)
//
// Causal and sliding-window masks; keys and rows past S are masked and
// nothing is written past S.  fp32 accumulators; each output is written
// once in the input's type.  No atomics anywhere: two calls are bit-equal.
//
// Bound on the card: 10 hd FLOPs per live (q, k) pair and head (S and dP
// recomputed, dV, dK and dQ: five products of 2 hd each) against 989
// TFLOP/s in bf16 (H100 SXM tensor cores); q, k, v, o, dO and lse read and
// dq, dk, dv written once against 3.35 TB/s.  At the training shapes the
// operations bound (0.0326 ms at B 8, S 1,024, H 12, hd 64; 0.3475 ms at
// B 2, S 4,096, H 16, hd 128, causal).  So every product runs on wgmma,
// the loads run ahead of the products through a ring, and only the masked
// tiles pay for a mask.
//
// MLA trains through the same kernels with q and k 192 wide (128 nope +
// 64 rope) and v 128 (DQK, DV): S and dP contract over 192 and 128, dV
// and dK are 128 and 192 wide, and the streamed tiles narrow to fit the
// wider accumulators (BwdTile).  Its bound is 2 (3 DQK + 2 DV) = 1,664
// FLOPs a live pair and head (S, dK and dQ over 192; dP and dV over 128),
// 2.6 times the forward's 2 (DQK + DV): at B 2, S 4,096, H 128, causal,
// 3.57 TFLOP, 3.6 ms at 989 TFLOP/s.
//
// recurrentgemma's local layers train at hd 256 (MQA, G 16, window 2,048):
// at B 1, S 4,096, 6,292,480 live pairs a head, 257.7 GFLOP at 10 hd, 0.261
// ms at 989 TFLOP/s.  gemma2's local and global layers train at hd 256 too
// (G 2, window 4,096 or none) under a softcap of 50.  Its consumers split
// an item's dK and dV between them (one computes S^T and hands P^T, or P^T
// (1 - tanh^2) under the softcap, to the other through shared memory) and
// its dK/dV items also split the group's q heads (BwdTile, SPLIT): three
// launches, the third summing the parts.
//
// bf16 route (hd 64, 128 and 256, and MLA's pair): persistent and
// warp-specialised like the forward: one block an SM, a producer
// warpgroup at 24 registers whose one thread issues every load by TMA
// (4-D maps, 64-row boxes, 128-byte swizzle) into mbarrier-guarded slots
// and a ring, two consumer warpgroups at 240 registers that run every
// product as wgmma.  The streamed tiles are BwdTile's BR q rows (dK/dV)
// and BN keys (dQ), 128 or 64.
//
// * flash_bwd_dq_wgmma, first: a work item is (b, q head, 128 rows), 64 a
//   consumer.  The producer loads the item's Q, dO and O and streams the K
//   and V tiles up to the causal frontier (from the window's start).  A
//   consumer first takes D = rowsum(dO o) of its rows from the dO and O
//   tiles and writes (lse log2 e, D) of each row, zeros past S, to a
//   scratch the dK/dV kernel streams (padded to whole 128-row tiles, so a
//   ring stage takes a tile's statistics by one bulk copy: a ragged S
//   leaves the lse's rows without the 16-byte strides a tensor map
//   needs).  Per tile: S = Q K^T and dP = dO V^T (wgmma, both operands
//   K-major in shared memory), P = 2^(S scale log2 e - lse log2 e) while
//   dP is still in flight, dS = P (dP - D), dQ += dS K (wgmma with dS
//   rounded to bf16 A fragments in registers, K MN-major through the
//   transpose bit).  dQ is scaled, rounded once, written over the
//   consumer's own Q rows and stored by TMA (rows past S clipped).
//   Recomputing S and dP here costs 4 hd FLOPs a live pair beyond the
//   bound's 10 (14 in all): the price of a dQ without atomics, which keeps
//   two calls bit-equal.
// * flash_bwd_dkdv_wgmma: a work item is (b, kv head, 128 keys), 64 a
//   consumer.  The producer loads the item's K and V once (two slots where
//   they fit, so the next item's load overlaps this one) and streams, for
//   each of the G q heads of the group, the Q and dO tiles from the causal
//   frontier to the window's end with their statistics.  Per tile: S^T = K Q^T, dP^T = V
//   dO^T, P^T, dS^T = P^T (dP^T - D), then dV += P^T dO and dK += dS^T Q
//   (P^T and dS^T as bf16 A fragments, dO and Q MN-major).  dK and dV stay
//   in fp32 registers across the G heads, so the sum over the group needs
//   no atomics; at the end they are scaled, rounded once, written over the
//   consumer's own K and V rows and stored by TMA.
//
// Every product is waited for in the iteration that issued it; the two
// consumers' products and exponentials overlap each other.  Only the
// tiles on the causal diagonal, at the window's edge or past S compute a
// mask.  Tile sizes, ring depths, shared-memory offsets and each block's
// work items, longest first, come from the host's plan
// (kernels/flash_attention.py:flash_bwd_plan); the kernels compute none of
// it.  Roles and items are broadcast by __shfl_sync so that ptxas sees
// them warp-uniform and does not serialise the wgmma.
//
// fp32 route (the card's exact path, for parity runs): a D pass, then the
// same walks on the CUDA cores, one block a (b, kv head, 64 keys) for
// dK/dV and a (b, q head, 64 rows) for dQ, a thread owning 4 x 4 score
// elements.
//
// cuTensorMapEncodeTiled comes from the driver through the runtime's
// cudaGetDriverEntryPoint(ByVersion), so the library links no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// fp32 route: D = rowsum(dO o), one warp a row of hd elements
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
flash_bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
                float* __restrict__ delta, int rows, int S, int H, int hd) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);   // (b * S + s) * H + h
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* op = o + (size_t)row * hd;
  const float* dp = dout + (size_t)row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(op[d], dp[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, bs = row / H, s = bs % S, b = bs / S;
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// Whether query position pq may see key position pk.
__device__ __forceinline__ bool live_pair(int pq, int pk, int Sq, int Sk,
                                          int causal, int window) {
  bool ok = pq < Sq && pk < Sk;
  if (causal) ok = ok && pk <= pq;
  if (window) ok = ok && pq - pk < window;
  return ok;
}

// ---------------------------------------------------------------------------
// bf16 route: TMA, mbarriers, wgmma; a producer and two consumer warpgroups
// ---------------------------------------------------------------------------
constexpr int BM = 128;   // dQ: q rows of a work item (64 a consumer)
// The streamed tiles: q rows of a dK/dV ring stage (BR) and keys of a dQ
// ring stage (BN), the N of the score products (m64nBR, m64nBN).  Wider
// tiles halve the products, ring rounds and waits a FLOP, but a consumer
// holds its accumulators (dK and dV: hd fp32 a thread; dQ: hd / 2) beside
// two score tiles (N / 2 each), and the softcap's passes need more.  So a
// tile is 128 wide where that fits in 240 registers without spilling
// (-Xptxas -v), else 64: the softcapped hd-64 dK/dV consumer spilled at
// 128 rows, the softcapped hd-128 dQ consumer at 128 keys.
//
// MLA (q and k 192 wide, v 128; no softcap) holds more: a dK/dV consumer's
// dK and dV are 64 x 192 + 64 x 128 fp32 over 128 threads, 160 registers
// a thread, so its streamed tile is 32 q rows (S^T and dP^T 16 each, their
// bf16 fragments 8 each: 200 in all); at 64 rows (32 + 32 + 16 + 16) it
// would need 256.  A dQ consumer's dQ is 64 x 192, 96 a thread, and its
// tile is 64 keys (S and dP 32 each, dS's fragments 16: 176); at 128 keys
// it would need 256.  The Q and dO boxes of a 32-row stage are 32 rows
// (QBOX).
//
// hd 256 (recurrentgemma's local layers: MQA, 16 q heads over one kv head,
// window 2,048; gemma2's: 16 q heads over 8 kv heads, a softcap of 50)
// holds still more: dK and dV of 64 keys are 256
// fp32 a thread, past the 240 a consumer has.  So the two consumers split
// the work of one 64-key item (BC 64) instead of its keys, over the same
// Q/dO stages of 64 rows (BR 64): consumer 0 (SPLIT, ROLE_DV) computes S^T
// = K Q^T and P^T, writes P^T in fp32 to a handover buffer in shared memory
// and accumulates dV += P^T dO; consumer 1 (ROLE_DK) computes dP^T = V dO^T
// meanwhile, takes P^T from the buffer, forms dS^T = P^T (dP^T - D) and
// accumulates dK += dS^T Q.  Each score tile is computed once (10 hd FLOPs
// a live pair in this kernel, 14 hd with the dQ kernel's S, dP and dQ, as
// at the other widths), and the two consumers do equal tensor work, two 64
// x 64 x 256 products a stage each.  Each holds 128 accumulators a thread
// beside one 64-wide score tile (32) and its bf16 fragments (16): 176.
// Two handover buffers (16 KB each: a thread's 32 floats as 8 float4s,
// 128 threads apart, in the accumulator's own order, which both consumers
// share) let consumer 0 start the next stage's S^T while consumer 1 still
// reads this one's P^T; mbarriers (every thread of a consumer arrives)
// order the writes and the reads.  The shared memory holds one 64 KB K/V
// slot, two 64 KB Q/dO stages and the two buffers, so an item's K/V load
// does not overlap the previous item (about one stage of an item's 33 to
// 66).  These take 231,504 of the 232,448 bytes a block may have, so a
// softcap (gemma2) gets no buffer of its own: under it dS^T = P^T (1 -
// th^2) (dP^T - D), and consumer 0, which computes th = tanh(s scale /
// cap) from its S^T and P^T = 2^(th cap log2 e - lse log2 e) from th,
// feeds P^T to its dV product from the bf16 fragments and hands P^T (1 -
// th^2) through the same buffers, in the same layout, under the same
// mbarriers (pcap_hand_cols); consumer 1 runs unchanged.  The cap adds th
// in place of the score and no register.  Under MQA the (b, kv head, 64
// keys) items are too few for the card (64 at B 1, S 4,096), so an item
// also takes one of ``kv_split`` equal parts of the group's q heads; the
// consumers write fp32 partials of dK and dV, and a short pass sums the
// parts in a fixed order (no atomics) and rounds once.  The dQ consumer's
// dQ is 64 x 256, 128 a thread, and its tile is 32 keys (S and dP 16
// each, dS's fragments 8: 168); its item's Q and dO take 128 KB, so O is
// not staged: D = rowsum(dO O) reads the rows from device memory (O_SMEM
// false), and three 32-key K/V stages of 32 KB fit beside them.
template <int DQK, int DV, bool CAP>
struct BwdTile {
  static constexpr bool SPLIT = DQK == 256;
  static constexpr int BR =
      DQK != DV ? 32 : (DQK == 64 && !CAP ? 128 : 64);
  static constexpr int BN =
      SPLIT ? 32 : DQK != DV ? 64 : (DQK == 128 && CAP ? 64 : 128);
  static constexpr int BC = SPLIT ? 64 : 128;   // dK/dV: keys of an item
  static constexpr int QBOX = BR < 64 ? BR : 64;
  static constexpr int KBOX = BN < 64 ? BN : 64;
  static constexpr bool O_SMEM = !SPLIT;        // dQ: O staged with dO
};
// What a split dK/dV consumer (hd 256) computes for its item's 64 keys.
constexpr int ROLE_DV = 1, ROLE_DK = 2;
constexpr int WG_THREADS = 384;
// setmaxnreg: (24 + 2 x 240) x 128 = 64,512 of the SM's 65,536 registers
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_LIMIT = 232448;

// The host's plan, field by field in the order of
// kernels/flash_attention.py:BWD_PLAN_FIELDS.  Offsets are bytes from the
// 1,024-aligned start of dynamic shared memory; items and starts are int
// offsets into the work buffer (items: 4 ints each, (b * heads + head,
// tile, first, end) with first..end - 1 the tiles the item walks, a dK/dV
// item's first int (b * KH + kv head) * kv_split + its part of the group's
// q heads; starts: a block's first item, one more entry than blocks).
// kv_hands P^T handover buffers at kv_off_hand (hd 256; 0 at the others).
struct BwdPlan {
  int br, bc, bm, bn, s_pad;
  int kv_blocks, kv_slots, kv_stages, kv_off_kv, kv_off_ring, kv_off_stats,
      kv_off_bars, kv_smem, kv_items, kv_starts, kv_split, kv_hands,
      kv_off_hand;
  int dq_blocks, dq_slots, dq_stages, dq_off_q, dq_off_ring, dq_off_bars,
      dq_smem, dq_items, dq_starts;
};
constexpr int BWD_PLAN_INTS = sizeof(BwdPlan) / sizeof(int);

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
// Blocks until the phase of parity ``parity`` of the barrier has completed.
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

// One box (64 columns of hd, 1 head, 64 rows, 1 batch row) of a 4-D tensor
// map into shared memory; rows past S arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head),
      "r"(row), "r"(batch), "r"(bar)
      : "memory");
}
// The reverse, from shared memory: rows past S are clipped.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int col, int head, int row,
                                          int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}
// ``bytes`` contiguous bytes (a multiple of 16, both ends 16-aligned).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts4(uint32_t addr, float a, float b, float c,
                                     float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
// The dot product of 8 bf16 pairs, added to acc.
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x[i]));
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&y[i]));
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
  return acc;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of wgmma registers across
// the fence, commit and wait instructions.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: every operand here is
// stored as blocks of 64 hd columns (128 bytes a row, the TMA box), 8-row
// groups 1,024 bytes apart (the stride byte offset).  ``lbo`` is the byte
// distance between two such column blocks, read only for an MN-major
// operand whose N spans several of them.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[0 .. 16) (+)= A (64 x 16, shared, K-major) . B (16 x 32, shared,
// K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0 .. 32) (+)= A (64 x 16, shared, K-major) . B (16 x 64, shared,
// K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0 .. 64) (+)= A (64 x 16, shared, K-major) . B (16 x 128, shared,
// K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[OFF .. OFF + 32) += A (64 x 16, registers) . B (16 x 64, shared,
// MN-major: the transpose-B bit).
template <int OFF, int T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[T],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]),
        "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]),
        "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]),
        "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[OFF .. OFF + 64) += A (64 x 16, registers) . B (16 x 128, shared,
// MN-major: the transpose-B bit).
template <int OFF, int T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[T],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]),
        "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]),
        "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]),
        "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]),
        "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]),
        "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]), "+f"(d[OFF + 48]), "+f"(d[OFF + 49]),
        "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]),
        "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A 64-row score-like tile (64 x N accumulator) = A . B^T over HD: A's 64
// rows at ``a`` (its column blocks ``a_rows`` * 128 bytes apart), B's N
// rows at ``b`` (column blocks N * 128 bytes apart), both K-major.  Within
// a 128-byte swizzle atom a k-step advances the start address by 32 bytes;
// every 4 k-steps move to the next 64-column block.
template <int HD, int N>
__device__ __forceinline__ void ss_tile(float (&d)[N / 2], uint32_t a,
                                        int a_rows, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint64_t da =
        sw128_desc(a + (ks >> 2) * a_rows * 128 + (ks & 3) * 32, 16);
    const uint64_t db = sw128_desc(b + (ks >> 2) * N * 128 + (ks & 3) * 32, 16);
    if constexpr (N == 32)
      wgmma_ss_n32(d, da, db, ks > 0);
    else if constexpr (N == 64)
      wgmma_ss_n64(d, da, db, ks > 0);
    else
      wgmma_ss_n128(d, da, db, ks > 0);
  }
}

// acc (64 x HD) += A (64 x K, bf16 fragments in registers) . B (K x HD at
// ``b``, MN-major: K rows of the product's k, column blocks K * 128 bytes
// apart); a k-step is 16 rows, 2,048 bytes of a column block.  HD 192 is
// an n128 product over column blocks 0 and 1 and an n64 over block 2,
// whose accumulators follow on (element 64 + i of the n64 is column 128 +
// the column of its element i); HD 256 two n128 products, over blocks 0
// and 1 and over blocks 2 and 3.
template <int HD, int K>
__device__ __forceinline__ void rs_tile(float (&acc)[HD / 2],
                                        const uint32_t (&a)[K / 16][4],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = sw128_desc(b + kk * 16 * 128, K * 128);
    if constexpr (HD == 64) {
      wgmma_rs_n64<0>(acc, a[kk], db);
    } else {
      wgmma_rs_n128<0>(acc, a[kk], db);
      const uint64_t db2 = sw128_desc(b + 2 * K * 128 + kk * 16 * 128, K * 128);
      if constexpr (HD == 192)
        wgmma_rs_n64<64>(acc, a[kk], db2);
      else if constexpr (HD == 256)
        wgmma_rs_n128<64>(acc, a[kk], db2);
    }
  }
}

// The fp32 accumulator of a 64 x (2 NS) tile, rounded to bf16, as the A
// fragments of a product over its columns: the accumulators of columns
// 16 kk .. 16 kk + 15 are exactly the A fragment of k-step kk.
template <int NS>
__device__ __forceinline__ void pack_a(uint32_t (&p)[NS / 8][4],
                                       const float (&s)[NS]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// 2^x on the MUFU unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// In a 64 x N accumulator a thread (warp w, lane 4 g + t) holds element i
// at row 16 w + g + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 t + (i & 1).
//
// dK/dV tiles are transposed (rows are keys, columns q rows), and a
// column's statistics come from the ring stage: lds4 at column 8 j + 2 t
// gives (lse log2 e, D) of columns 8 j + 2 t and 8 j + 2 t + 1.  A masked
// tile keeps, in row r, the columns in [lo[r], hi[r]) (absolute positions).
//
// P^T in place of S^T (no softcap).
template <bool MASK, int NS>
__device__ __forceinline__ void p_cols(float (&s)[NS], uint32_t st, float sc,
                                       int col0, const int (&lo)[2],
                                       const int (&hi)[2]) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    const float4 v = lds4(st + (8 * j) * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, r = e >> 1, col = col0 + 8 * j + (e & 1);
      float p = ex2(fmaf(s[i], sc, -((e & 1) ? v.z : v.x)));
      if constexpr (MASK) p = col >= lo[r] && col < hi[r] ? p : 0.f;
      s[i] = p;
    }
  }
}
// dS^T = P^T (dP^T - D), in place of dP^T.
template <int NS>
__device__ __forceinline__ void ds_cols(const float (&p)[NS], float (&dp)[NS],
                                        uint32_t st) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    const float4 v = lds4(st + (8 * j) * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      dp[i] = p[i] * (dp[i] - ((e & 1) ? v.w : v.y));
    }
  }
}
// The same with P^T from a handover buffer: elements 4 j .. 4 j + 3 of this
// thread's tile at ``hand`` + 2,048 j (dkdv_consume).
template <int NS>
__device__ __forceinline__ void ds_cols_handed(uint32_t hand, float (&dp)[NS],
                                               uint32_t st) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    const float4 v = lds4(st + (8 * j) * 8);
    const float4 p = lds4(hand + j * 128 * 16);
    dp[4 * j] = p.x * (dp[4 * j] - v.y);
    dp[4 * j + 1] = p.y * (dp[4 * j + 1] - v.w);
    dp[4 * j + 2] = p.z * (dp[4 * j + 2] - v.y);
    dp[4 * j + 3] = p.w * (dp[4 * j + 3] - v.w);
  }
}

// tanh(x) = 1 - 2 / (1 + e^2x) on the MUFU unit, branch-free and lighter
// in registers than tanhf: its absolute error (about 1e-7) moves P by cap
// log2 e times that in the exponent, far inside the tolerance.
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, 1.f + ex2(x * (2.f * LOG2E)));
}

// Under a softcap, three passes, each reading two of a column's four
// statistics as the plain passes do: th = tanh(s scale / cap) in place of
// the score (while dP is in flight), then (dP - D)(1 - th^2) in place of
// dP, then P = 2^(th cap log2 e - lse log2 e) in place of th and dS = P
// times the second.
template <int NS>
__device__ __forceinline__ void tanh_tile(float (&s)[NS], float sc) {
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = tanh_fast(s[i] * sc);
}
template <int NS>
__device__ __forceinline__ void dcap_cols(const float (&th)[NS],
                                          float (&dp)[NS], uint32_t st) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    const float4 v = lds4(st + (8 * j) * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      dp[i] = (dp[i] - ((e & 1) ? v.w : v.y)) * (1.f - th[i] * th[i]);
    }
  }
}
template <bool MASK, int NS>
__device__ __forceinline__ void pcap_cols(float (&th)[NS], float (&dp)[NS],
                                          uint32_t st, float cl, int col0,
                                          const int (&lo)[2],
                                          const int (&hi)[2]) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    const float4 v = lds4(st + (8 * j) * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, r = e >> 1, col = col0 + 8 * j + (e & 1);
      float p = ex2(fmaf(th[i], cl, -((e & 1) ? v.z : v.x)));
      if constexpr (MASK) p = col >= lo[r] && col < hi[r] ? p : 0.f;
      th[i] = p;
      dp[i] *= p;
    }
  }
}

// Under a softcap, consumer 0 of a split dK/dV item (hd 256), with th =
// tanh(s scale / cap) in place of S^T (tanh_tile): P^T = 2^(th cap log2 e -
// lse log2 e) rounded into the bf16 A fragments of dV's product (pack_a's
// order), and P^T (1 - th^2) in place of th, the tile it hands to consumer
// 1, which forms dS^T = that (dP^T - D) (ds_cols_handed).  No register
// beyond the unmasked route's: P^T lives only in the fragments.
template <bool MASK, int NS>
__device__ __forceinline__ void pcap_hand_cols(float (&th)[NS],
                                               uint32_t (&pa)[NS / 8][4],
                                               uint32_t st, float cl,
                                               int col0, const int (&lo)[2],
                                               const int (&hi)[2]) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    const float4 v = lds4(st + (8 * j) * 8);
    float pj[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, r = e >> 1, col = col0 + 8 * j + (e & 1);
      float p = ex2(fmaf(th[i], cl, -((e & 1) ? v.z : v.x)));
      if constexpr (MASK) p = col >= lo[r] && col < hi[r] ? p : 0.f;
      pj[e] = p;
      th[i] = p * (1.f - th[i] * th[i]);
    }
    pa[j >> 1][2 * (j & 1)] = pack_bf16(pj[0], pj[1]);
    pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(pj[2], pj[3]);
  }
}

// dQ tiles are not transposed: rows are q rows, whose statistics a thread
// keeps in registers (l2: lse log2 e, d: D), columns keys.
template <bool MASK, int NS>
__device__ __forceinline__ void p_rows(float (&s)[NS], float sc,
                                       const float (&l2)[2], int col0,
                                       const int (&lo)[2], const int (&hi)[2]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1, col = col0 + 8 * (i >> 2) + (i & 1);
    float p = ex2(fmaf(s[i], sc, -l2[r]));
    if constexpr (MASK) p = col >= lo[r] && col < hi[r] ? p : 0.f;
    s[i] = p;
  }
}
template <int NS>
__device__ __forceinline__ void ds_rows(const float (&p)[NS], float (&dp)[NS],
                                        const float (&d)[2]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) dp[i] = p[i] * (dp[i] - d[(i >> 1) & 1]);
}
// The softcap's second and third passes over rows (as the columns').
template <int NS>
__device__ __forceinline__ void dcap_rows(const float (&th)[NS],
                                          float (&dp)[NS],
                                          const float (&d)[2]) {
#pragma unroll
  for (int i = 0; i < NS; ++i)
    dp[i] = (dp[i] - d[(i >> 1) & 1]) * (1.f - th[i] * th[i]);
}
template <bool MASK, int NS>
__device__ __forceinline__ void pcap_rows(float (&th)[NS], float (&dp)[NS],
                                          float cl, const float (&l2)[2],
                                          int col0, const int (&lo)[2],
                                          const int (&hi)[2]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1, col = col0 + 8 * (i >> 2) + (i & 1);
    float p = ex2(fmaf(th[i], cl, -l2[r]));
    if constexpr (MASK) p = col >= lo[r] && col < hi[r] ? p : 0.f;
    th[i] = p;
    dp[i] *= p;
  }
}

// A work item of the plan, the same in every thread of a warp: lane 0
// reads it, the others take it by shuffle (so ptxas sees it warp-uniform).
__device__ __forceinline__ int4 uniform_item(const int* work, int at) {
  int4 u = make_int4(0, 0, 0, 0);
  if ((threadIdx.x & 31) == 0) u = *reinterpret_cast<const int4*>(work + at);
  u.x = __shfl_sync(0xffffffffu, u.x, 0);
  u.y = __shfl_sync(0xffffffffu, u.y, 0);
  u.z = __shfl_sync(0xffffffffu, u.z, 0);
  u.w = __shfl_sync(0xffffffffu, u.w, 0);
  return u;
}
__device__ __forceinline__ int uniform_int(const int* p) {
  int v = 0;
  if ((threadIdx.x & 31) == 0) v = *p;
  return __shfl_sync(0xffffffffu, v, 0);
}

// A consumer's bf16 result (64 rows x HD, fp32 accumulator times ``mul``)
// into its rows of a shared-memory tile in the TMA box layout (column
// blocks ``rows`` * 128 bytes apart, 128-byte swizzle), from where a TMA
// store writes it.
template <int HD>
__device__ __forceinline__ void stage_out(uint32_t dst, int rows,
                                          const float (&acc)[HD / 2],
                                          float mul, int warp, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = 16 * warp + g + 8 * rr;
      const uint32_t addr = dst + (j >> 3) * rows * 128 + row * 128 +
                            (((j & 7) ^ (row & 7)) << 4) + 4 * tq;
      const uint32_t v = pack_bf16(acc[4 * j + 2 * rr] * mul,
                                   acc[4 * j + 2 * rr + 1] * mul);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v)
                   : "memory");
    }
}

// A warp's release of a barrier, once its wgmma reads are complete.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// What a split dK/dV consumer (hd 256) needs beyond the plan:
// shared-memory regions, the shapes, the scales and where its partial goes.
struct KvArgs {
  uint32_t kv_s, ring, st_s, hand, bars;
  int KVS, NST, NH, G, B, Sq, Sk, KH, causal, window, r_begin, r_end;
  float sc, cl, scale;
  const int* work;
  float* part;              // fp32 partials of dK, then of dV
};

// A consumer's fp32 result (64 keys x HD) into its part of the partials
// (kv_split, B, Sk, KH, HD), keys past Sk skipped.
template <int HD>
__device__ __forceinline__ void store_part(float* dst,
                                           const float (&acc)[HD / 2],
                                           int key0, int Sk, int KH, int warp,
                                           int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = key0 + 16 * warp + g + 8 * rr;
    if (key >= Sk) continue;
    float* row = dst + (size_t)key * KH * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * tq) =
          make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
  }
}

// A split dK/dV consumer warpgroup's walk over its block's items (hd 256),
// over the same ring stages: ROLE_DV computes S^T and P^T, hands P^T (under
// a softcap P^T (1 - th^2)) over and accumulates dV += P^T dO; ROLE_DK
// computes dP^T, takes the handed tile, forms dS^T and accumulates dK +=
// dS^T Q.  A stage goes back to the producer after the 8 consumer warps
// have read it, a handover buffer to ROLE_DV after the 128 threads of
// ROLE_DK have read it.  Each writes its fp32 partial of the item's 64
// keys (dK unscaled: the sum pass scales it).
template <int DQK, int DV, bool CAP, int ROLE>
__device__ __forceinline__ void dkdv_consume(const BwdPlan& p,
                                             const KvArgs& a, int cw) {
  using Tile = BwdTile<DQK, DV, CAP>;
  constexpr int BR = Tile::BR, NS = BR / 2, BC = Tile::BC;
  constexpr bool DK = ROLE == ROLE_DK;
  constexpr int ACC = DK ? DQK / 2 : DV / 2;
  constexpr int K_BYTES = BC * DQK * 2;        // an item's K
  constexpr int KV_BYTES = K_BYTES + BC * DV * 2;   // ... and its V
  constexpr int QT_BYTES = BR * DQK * 2;       // a stage's Q
  constexpr int ST_BYTES = QT_BYTES + BR * DV * 2;  // ... and its dO
  constexpr int HAND_BYTES = BC * BR * 4;      // a P^T handover buffer
  auto kv_full = [&](int i) { return a.bars + 8 * i; };
  auto kv_empty = [&](int i) { return a.bars + 8 * (a.KVS + i); };
  auto full = [&](int s) { return a.bars + 8 * (2 * a.KVS + s); };
  auto empty = [&](int s) { return a.bars + 8 * (2 * a.KVS + a.NST + s); };
  auto hand_full = [&](int h) {
    return a.bars + 8 * (2 * a.KVS + 2 * a.NST + h);
  };
  auto hand_empty = [&](int h) {
    return a.bars + 8 * (2 * a.KVS + 2 * a.NST + a.NH + h);
  };
  const int t = threadIdx.x - 128 * (cw + 1), warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int split = p.kv_split, heads = a.G / split;
  const int Sq = a.Sq, Sk = a.Sk, causal = a.causal, window = a.window;
  int it = 0;                                // ring stages consumed
  for (int r = a.r_begin; r < a.r_end; ++r) {
    const int4 u = uniform_item(a.work, p.kv_items + 4 * r);
    const int bh = u.x / split, part = u.x % split;
    const int b = bh / a.KH, kh = bh % a.KH, n = r - a.r_begin;
    const int slot = n % a.KVS;
    const int kc = u.y * BC;                   // the item's first key
    const uint32_t ka = a.kv_s + slot * KV_BYTES;
    const uint32_t va = ka + K_BYTES;
    // the q rows [lo, hi) each of this thread's two keys sees
    int lo[2], hi[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = kc + 16 * warp + g + 8 * rr;
      lo[rr] = causal ? key : 0;
      hi[rr] = key >= Sk ? -1 : (window ? min(Sq, key + window) : Sq);
    }
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    mbar_wait(kv_full(slot), (n / a.KVS) & 1);
    for (int gi = part * heads; gi < (part + 1) * heads; ++gi) {
      for (int qt = u.z; qt < u.w; ++qt, ++it) {
        const int s = it % a.NST, q0 = qt * BR, hb = it % a.NH;
        const uint32_t qs = a.ring + s * ST_BYTES, os = qs + QT_BYTES;
        const uint32_t st = a.st_s + s * BR * 8 + (2 * tq) * 8;
        // this thread's elements of the stage's P^T: 4 j .. 4 j + 3 at
        // hand + 2,048 j, the 128 threads' float4s side by side
        const uint32_t hand = a.hand + hb * HAND_BYTES + t * 16;
        const uint32_t hpar = (it / a.NH) & 1;
        float sv[NS];
        mbar_wait(full(s), (it / a.NST) & 1);
        wgmma_fence();
        if constexpr (DK)
          ss_tile<DV, BR>(sv, va, BC, os);   // dP^T = V dO^T
        else
          ss_tile<DQK, BR>(sv, ka, BC, qs);  // S^T = K Q^T
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sv);
        uint32_t fa[BR / 16][4];
        if constexpr (DK) {
          // dS^T = P^T (dP^T - D) (under a softcap the handed P^T (1 -
          // th^2) times dP^T - D) in place of dP^T, then the buffer back
          mbar_wait(hand_full(hb), hpar);
          ds_cols_handed<NS>(hand, sv, st);
          mbar_arrive(hand_empty(hb));
          pack_a<NS>(fa, sv);
        } else {
          // a mask iff some pair of the tile is dead: keys past Sk, rows
          // past Sq, a row before the key (causal), a row past the window
          const bool mask = kc + 64 > Sk || q0 + BR > Sq ||
                            (causal && q0 < kc + 63) ||
                            (window && q0 + BR - 1 - kc >= window);
          const int col0 = q0 + 2 * tq;
          if constexpr (CAP) {
            // th in place of S^T, then P^T into fa and P^T (1 - th^2),
            // the handed tile, in place of th
            tanh_tile(sv, a.sc);
            if (mask)
              pcap_hand_cols<true, NS>(sv, fa, st, a.cl, col0, lo, hi);
            else
              pcap_hand_cols<false, NS>(sv, fa, st, a.cl, col0, lo, hi);
          } else {
            if (mask)
              p_cols<true, NS>(sv, st, a.sc, col0, lo, hi);
            else
              p_cols<false, NS>(sv, st, a.sc, col0, lo, hi);
            pack_a<NS>(fa, sv);
          }
        }
        wgmma_fence();
        if constexpr (DK)
          rs_tile<DQK, BR>(acc, fa, qs);     // dK += dS^T Q
        else
          rs_tile<DV, BR>(acc, fa, os);      // dV += P^T dO
        wgmma_commit();
        if constexpr (!DK) {
          // the handed tile to the other consumer while dV's product runs
          mbar_wait(hand_empty(hb), hpar ^ 1);
#pragma unroll
          for (int j = 0; j < NS / 4; ++j)
            sts4(hand + j * 128 * 16, sv[4 * j], sv[4 * j + 1], sv[4 * j + 2],
                 sv[4 * j + 3]);
          mbar_arrive(hand_full(hb));
        }
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence(fa);
        release(empty(s), lane);
      }
    }
    // epilogue: the slot goes back once every warp of the consumer is past
    // its last product (the next item's K and V load while this part's
    // fp32 partial goes out from registers)
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if (t == 0) mbar_arrive(kv_empty(slot));
    const size_t at = (((size_t)part * a.B + b) * Sk) * a.KH + kh;
    if constexpr (DK)
      store_part<DQK>(a.part + at * DQK, acc, kc, Sk, a.KH, warp, lane);
    else
      store_part<DV>(a.part + (size_t)split * a.B * Sk * a.KH * DQK +
                         at * DV,
                     acc, kc, Sk, a.KH, warp, lane);
  }
}

// dK, dV.  Warpgroup 0 is the producer (one thread issues every load),
// warpgroups 1 and 2 the consumers, each owning 64 of an item's 128 keys,
// or at hd 256 (SPLIT) one of dK and dV of its 64 keys (dkdv_consume).
// Both consumers walk the same ring stages; a stage goes back to the
// producer after the 8 consumer warps have read it.
template <int DQK, int DV, bool CAP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap dmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap dkmap,
                     const __grid_constant__ CUtensorMap dvmap,
                     const float2* __restrict__ stats,
                     const int* __restrict__ work, const BwdPlan p, int B,
                     int Sq, int Sk, int H, int KH, float sc, float cl,
                     float scale, int causal, int window,
                     float* __restrict__ part) {
  using Tile = BwdTile<DQK, DV, CAP>;
  constexpr int BR = Tile::BR, NS = BR / 2, QBOX = Tile::QBOX, BC = Tile::BC;
  constexpr int K_BYTES = BC * DQK * 2;        // an item's K
  constexpr int KV_BYTES = K_BYTES + BC * DV * 2;   // ... and its V
  constexpr int QT_BYTES = BR * DQK * 2;       // a stage's Q
  constexpr int ST_BYTES = QT_BYTES + BR * DV * 2;  // ... and its dO
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = base + p.kv_off_kv, ring = base + p.kv_off_ring;
  const uint32_t st_s = base + p.kv_off_stats, bars = base + p.kv_off_bars;
  const int KVS = p.kv_slots, NST = p.kv_stages, G = H / KH;
  // the parts of a group's q heads (hd 256; 1 at the other widths)
  const int split = Tile::SPLIT ? p.kv_split : 1;
  auto kv_full = [&](int i) { return bars + 8 * i; };
  auto kv_empty = [&](int i) { return bars + 8 * (KVS + i); };
  auto full = [&](int s) { return bars + 8 * (2 * KVS + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * KVS + NST + s); };
  const int r_begin = uniform_int(work + p.kv_starts + blockIdx.x);
  const int r_end = uniform_int(work + p.kv_starts + blockIdx.x + 1);

  if (threadIdx.x == 0) {
    for (int i = 0; i < KVS; ++i) {
      mbar_init(kv_full(i), 1);
      mbar_init(kv_empty(i), 2);       // thread 0 of each consumer
    }
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);          // every consumer warp
    }
    // hd 256: the P^T handover buffers' full and empty barriers, after the
    // ring's (every thread of the consumer that writes or reads arrives)
    for (int h = 0; h < 2 * p.kv_hands; ++h)
      mbar_init(bars + 8 * (2 * KVS + 2 * NST + h), 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: per item K and V, then per (q head of its part, q
    // tile) Q, dO and the tile's statistics --------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int it = 0;                              // ring stages filled so far
      const int heads = G / split;
      for (int r = r_begin; r < r_end; ++r) {
        const int4 u = *reinterpret_cast<const int4*>(work + p.kv_items +
                                                      4 * r);
        const int bh = u.x / split, gp = u.x % split;
        const int b = bh / KH, kh = bh % KH, n = r - r_begin;
        const int slot = n % KVS;
        mbar_wait(kv_empty(slot), ((n / KVS) & 1) ^ 1);
        mbar_expect_tx(kv_full(slot), KV_BYTES);
        const uint32_t ks = kv_s + slot * KV_BYTES;
#pragma unroll
        for (int half = 0; half < BC / 64; ++half) {
          const int row = u.y * BC + 64 * half;
#pragma unroll
          for (int c = 0; c < DQK / 64; ++c)
            tma_load(ks + c * BC * 128 + half * 64 * 128, &kmap,
                     kv_full(slot), 64 * c, kh, row, b);
#pragma unroll
          for (int c = 0; c < DV / 64; ++c)
            tma_load(ks + K_BYTES + c * BC * 128 + half * 64 * 128, &vmap,
                     kv_full(slot), 64 * c, kh, row, b);
        }
        for (int gi = gp * heads; gi < (gp + 1) * heads; ++gi) {
          const int h = kh * G + gi;
          const float2* st_h = stats + (size_t)(b * H + h) * p.s_pad;
          for (int qt = u.z; qt < u.w; ++qt, ++it) {
            const int s = it % NST;
            mbar_wait(empty(s), ((it / NST) & 1) ^ 1);
            mbar_expect_tx(full(s), ST_BYTES + BR * 8);
            const uint32_t qs = ring + s * ST_BYTES;
#pragma unroll
            for (int prt = 0; prt < BR / QBOX; ++prt) {
              const int row = qt * BR + QBOX * prt;
#pragma unroll
              for (int c = 0; c < DQK / 64; ++c)
                tma_load(qs + c * BR * 128 + prt * QBOX * 128, &qmap,
                         full(s), 64 * c, h, row, b);
#pragma unroll
              for (int c = 0; c < DV / 64; ++c)
                tma_load(qs + QT_BYTES + c * BR * 128 + prt * QBOX * 128,
                         &dmap, full(s), 64 * c, h, row, b);
            }
            bulk_load(st_s + s * BR * 8, st_h + qt * BR, BR * 8, full(s));
          }
        }
      }
    }
  } else {
    // ---- consumers -------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;
    if constexpr (Tile::SPLIT) {
      const KvArgs a{kv_s, ring, st_s, base + p.kv_off_hand, bars, KVS,
                     NST, p.kv_hands, G, B, Sq, Sk, KH, causal, window,
                     r_begin,
                     r_end, sc, cl, scale, work, part};
      if (cw == 0)
        dkdv_consume<DQK, DV, CAP, ROLE_DV>(p, a, cw);
      else
        dkdv_consume<DQK, DV, CAP, ROLE_DK>(p, a, cw);
    } else {
      const int t = threadIdx.x - 128 * wg, warp = t >> 5, lane = t & 31;
      const int g = lane >> 2, tq = lane & 3;
      int it = 0;                                // ring stages consumed
      for (int r = r_begin; r < r_end; ++r) {
        const int4 u = uniform_item(work, p.kv_items + 4 * r);
        const int b = u.x / KH, kh = u.x % KH, n = r - r_begin;
        const int slot = n % KVS;
        const int kc = u.y * BC + 64 * cw;       // this consumer's first key
        const uint32_t ka = kv_s + slot * KV_BYTES + 64 * cw * 128;
        const uint32_t va = ka + K_BYTES;
        // the q rows [lo, hi) each of this thread's two keys sees
        int lo[2], hi[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int key = kc + 16 * warp + g + 8 * rr;
          lo[rr] = causal ? key : 0;
          hi[rr] = key >= Sk ? -1 : (window ? min(Sq, key + window) : Sq);
        }
        float dk[DQK / 2], dv[DV / 2];
#pragma unroll
        for (int i = 0; i < DQK / 2; ++i) dk[i] = 0.f;
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
        mbar_wait(kv_full(slot), (n / KVS) & 1);
        for (int gi = 0; gi < G; ++gi) {
          for (int qt = u.z; qt < u.w; ++qt, ++it) {
            const int s = it % NST, q0 = qt * BR;
            const uint32_t qs = ring + s * ST_BYTES, os = qs + QT_BYTES;
            const uint32_t st = st_s + s * BR * 8 + (2 * tq) * 8;
            // a mask iff some pair of the tile is dead: keys past Sk, rows
            // past Sq, a row before the key (causal), a row past the window
            const bool mask = kc + 64 > Sk || q0 + BR > Sq ||
                              (causal && q0 < kc + 63) ||
                              (window && q0 + BR - 1 - kc >= window);
            const int col0 = q0 + 2 * tq;
            float sv[NS], dp[NS];
            mbar_wait(full(s), (it / NST) & 1);
            wgmma_fence();
            ss_tile<DQK, BR>(sv, ka, BC, qs);    // S^T = K Q^T
            wgmma_commit();
            ss_tile<DV, BR>(dp, va, BC, os);     // dP^T = V dO^T
            wgmma_commit();
            if constexpr (CAP) {
              wgmma_wait<1>();                   // S^T; dP^T in flight
              reg_fence(sv);
              tanh_tile(sv, sc);
              wgmma_wait<0>();
              reg_fence(dp);
              dcap_cols(sv, dp, st);
              if (mask)
                pcap_cols<true, NS>(sv, dp, st, cl, col0, lo, hi);
              else
                pcap_cols<false, NS>(sv, dp, st, cl, col0, lo, hi);
            } else {
              wgmma_wait<1>();                   // S^T; dP^T in flight
              reg_fence(sv);
              if (mask)
                p_cols<true, NS>(sv, st, sc, col0, lo, hi);
              else
                p_cols<false, NS>(sv, st, sc, col0, lo, hi);
              wgmma_wait<0>();
              reg_fence(dp);
              ds_cols(sv, dp, st);
            }
            uint32_t pa[BR / 16][4], da[BR / 16][4];
            pack_a<NS>(pa, sv);
            pack_a<NS>(da, dp);
            wgmma_fence();
            rs_tile<DV, BR>(dv, pa, os);         // dV += P^T dO
            rs_tile<DQK, BR>(dk, da, qs);        // dK += dS^T Q
            wgmma_commit();
            wgmma_wait<0>();
            reg_fence(dv);
            reg_fence(dk);
            reg_fence(pa);
            reg_fence(da);
            release(empty(s), lane);
          }
        }
        // epilogue: dK scale and dV in bf16 over this consumer's own K and V
        // rows (no product reads them any more), then TMA stores, which clip
        // the keys past Sk; the slot goes back to the producer once the
        // stores have read it
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
        stage_out<DQK>(ka, BC, dk, scale, warp, lane);
        stage_out<DV>(va, BC, dv, 1.f, warp, lane);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
        if (t == 0) {
#pragma unroll
          for (int c = 0; c < DQK / 64; ++c)
            tma_store(&dkmap, ka + c * BC * 128, 64 * c, kh, kc, b);
#pragma unroll
          for (int c = 0; c < DV / 64; ++c)
            tma_store(&dvmap, va + c * BC * 128, 64 * c, kh, kc, b);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          mbar_arrive(kv_empty(slot));
        }
      }
      if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
  }
}

// hd 256: dK = scale x the sum of its kv_split fp32 partials and dV the sum
// of its, in part order, rounded once to bf16; ``n`` elements of each (B,
// Sk, KH, 256), a multiple of 4, 4 a thread.
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_sum(const float* __restrict__ part, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int split, size_t n, float scale) {
  const size_t i = ((size_t)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const bool is_v = i >= n;
  const size_t e = is_v ? i - n : i;
  const float* src = part + (is_v ? (size_t)split * n : 0) + e;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < split; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(src + (size_t)k * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float mul = is_v ? 1.f : scale;
  uint2 out;
  out.x = pack_bf16(acc.x * mul, acc.y * mul);
  out.y = pack_bf16(acc.z * mul, acc.w * mul);
  *reinterpret_cast<uint2*>((is_v ? dv : dk) + e) = out;
}

// dQ, and the statistics the dK/dV kernel reads.  Warpgroup 0 is the
// producer, warpgroups 1 and 2 the consumers, each owning 64 of an item's
// 128 q rows; both walk the same K and V stages.  A consumer first
// computes D = rowsum(dO o) of its rows from the item's dO and O tiles and
// writes (lse log2 e, D) of every row of the item, zeros past S, to
// ``stats`` (B, H, s_pad) for the dK/dV kernel, launched after this one
// (at hd 256 from the rows of dO and O in device memory, ``og``, ``dog``).
template <int DQK, int DV, bool CAP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap dmap,
                   const __grid_constant__ CUtensorMap omap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap dqmap,
                   const float* __restrict__ lse,
                   float2* __restrict__ stats,
                   const int* __restrict__ work, const BwdPlan p, int Sq,
                   int Sk, int H, int KH, float sc, float cl, float scale,
                   int causal, int window, const bf16* __restrict__ og,
                   const bf16* __restrict__ dog) {
  using Tile = BwdTile<DQK, DV, CAP>;
  constexpr int BN = Tile::BN, NS = BN / 2, KBOX = Tile::KBOX;
  constexpr bool O_SMEM = Tile::O_SMEM;
  constexpr int Q_BYTES = BM * DQK * 2;        // an item's Q
  constexpr int D_BYTES = BM * DV * 2;         // ... its dO (and O)
  constexpr int SLOT_BYTES = Q_BYTES + (O_SMEM ? 2 : 1) * D_BYTES;
  constexpr int KT_BYTES = BN * DQK * 2;       // a stage's K
  constexpr int ST_BYTES = KT_BYTES + BN * DV * 2;  // ... and its V
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base + p.dq_off_q, ring = base + p.dq_off_ring;
  const uint32_t bars = base + p.dq_off_bars;
  const int QS = p.dq_slots, NST = p.dq_stages, G = H / KH;
  auto q_full = [&](int i) { return bars + 8 * i; };
  auto q_empty = [&](int i) { return bars + 8 * (QS + i); };
  auto full = [&](int s) { return bars + 8 * (2 * QS + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * QS + NST + s); };
  const int r_begin = uniform_int(work + p.dq_starts + blockIdx.x);
  const int r_end = uniform_int(work + p.dq_starts + blockIdx.x + 1);

  if (threadIdx.x == 0) {
    for (int i = 0; i < QS; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), 2);        // thread 0 of each consumer
    }
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);          // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: per item Q, dO and O, then the K and V tiles --------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int r = r_begin; r < r_end; ++r) {
        const int4 u = *reinterpret_cast<const int4*>(work + p.dq_items +
                                                      4 * r);
        const int b = u.x / H, h = u.x % H, kh = h / G, n = r - r_begin;
        const int slot = n % QS;
        mbar_wait(q_empty(slot), ((n / QS) & 1) ^ 1);
        mbar_expect_tx(q_full(slot), SLOT_BYTES);
        const uint32_t qsl = q_s + slot * SLOT_BYTES;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = u.y * BM + 64 * half;
#pragma unroll
          for (int c = 0; c < DQK / 64; ++c)
            tma_load(qsl + c * BM * 128 + half * 64 * 128, &qmap,
                     q_full(slot), 64 * c, h, row, b);
#pragma unroll
          for (int c = 0; c < DV / 64; ++c) {
            const uint32_t o = Q_BYTES + c * BM * 128 + half * 64 * 128;
            tma_load(qsl + o, &dmap, q_full(slot), 64 * c, h, row, b);
            if constexpr (O_SMEM)
              tma_load(qsl + D_BYTES + o, &omap, q_full(slot), 64 * c, h,
                       row, b);
          }
        }
        for (int j = u.z; j < u.w; ++j, ++it) {
          const int s = it % NST;
          mbar_wait(empty(s), ((it / NST) & 1) ^ 1);
          mbar_expect_tx(full(s), ST_BYTES);
          const uint32_t ks = ring + s * ST_BYTES;
#pragma unroll
          for (int part = 0; part < BN / KBOX; ++part) {
            const int row = j * BN + KBOX * part;
#pragma unroll
            for (int c = 0; c < DQK / 64; ++c)
              tma_load(ks + c * BN * 128 + part * KBOX * 128, &kmap, full(s),
                       64 * c, kh, row, b);
#pragma unroll
            for (int c = 0; c < DV / 64; ++c)
              tma_load(ks + KT_BYTES + c * BN * 128 + part * KBOX * 128,
                       &vmap, full(s), 64 * c, kh, row, b);
          }
        }
      }
    }
  } else {
    // ---- consumers -------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int t = threadIdx.x - 128 * wg, warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, tq = lane & 3;
    int it = 0;
    for (int r = r_begin; r < r_end; ++r) {
      const int4 u = uniform_item(work, p.dq_items + 4 * r);
      const int b = u.x / H, h = u.x % H, n = r - r_begin;
      const int slot = n % QS;
      const int r0 = u.y * BM + 64 * cw;       // this consumer's first row
      const uint32_t qa = q_s + slot * SLOT_BYTES + 64 * cw * 128;
      const uint32_t oa = qa + Q_BYTES;        // dO; O follows at D_BYTES
      const size_t bh = (size_t)b * H + h;
      // this thread's two rows: lse log2 e and the keys [lo, hi) each sees
      float l2[2], dd[2];
      int lo[2], hi[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = r0 + 16 * warp + g + 8 * rr;
        l2[rr] = row < Sq ? lse[bh * Sq + row] * LOG2E : 0.f;
        lo[rr] = window ? row - window + 1 : 0;
        hi[rr] = row >= Sq ? -(1 << 30) : (causal ? min(row + 1, Sk) : Sk);
      }
      float dq[DQK / 2];
#pragma unroll
      for (int i = 0; i < DQK / 2; ++i) dq[i] = 0.f;
      mbar_wait(q_full(slot), (n / QS) & 1);
      {
        // D of row rl (two threads a row, half of DV each, from the
        // swizzled dO and O tiles; rows past S are zeros there); warp w
        // holds rows 16 w .. 16 w + 15, so this thread's rows 16 w + g and
        // + 8 come from lanes 2 g and 2 g + 16
        const int rl = t >> 1, half = t & 1, row = r0 + rl;
        float d = 0.f;
        if constexpr (O_SMEM) {
#pragma unroll
          for (int j = half * (DV / 16); j < (half + 1) * (DV / 16); ++j) {
            const uint32_t off = (j >> 3) * BM * 128 + rl * 128 +
                                 (((j & 7) ^ (rl & 7)) << 4);
            d = dot8(lds128(oa + off), lds128(oa + D_BYTES + off), d);
          }
        } else if (row < Sq) {
          // 16-byte chunks of the row in device memory, in the same order
          const size_t at = (((size_t)b * Sq + row) * H + h) * DV;
          const uint4* orow = reinterpret_cast<const uint4*>(og + at);
          const uint4* drow = reinterpret_cast<const uint4*>(dog + at);
#pragma unroll 4
          for (int j = half * (DV / 16); j < (half + 1) * (DV / 16); ++j)
            d = dot8(__ldg(drow + j), __ldg(orow + j), d);
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        if (half == 0)
          stats[bh * p.s_pad + row] =
              make_float2(row < Sq ? lse[bh * Sq + row] * LOG2E : 0.f, d);
        dd[0] = __shfl_sync(0xffffffffu, d, 2 * g);
        dd[1] = __shfl_sync(0xffffffffu, d, 2 * g + 16);
      }
      for (int j = u.z; j < u.w; ++j, ++it) {
        const int s = it % NST, t0 = j * BN;
        const uint32_t ks = ring + s * ST_BYTES, vs = ks + KT_BYTES;
        const bool mask = t0 + BN > Sk || r0 + 64 > Sq ||
                          (causal && t0 + BN - 1 > r0) ||
                          (window && r0 + 63 - t0 >= window);
        const int col0 = t0 + 2 * tq;
        float sv[NS], dp[NS];
        mbar_wait(full(s), (it / NST) & 1);
        wgmma_fence();
        ss_tile<DQK, BN>(sv, qa, BM, ks);      // S = Q K^T
        wgmma_commit();
        ss_tile<DV, BN>(dp, oa, BM, vs);       // dP = dO V^T
        wgmma_commit();
        if constexpr (CAP) {
          wgmma_wait<1>();
          reg_fence(sv);
          tanh_tile(sv, sc);
          wgmma_wait<0>();
          reg_fence(dp);
          dcap_rows(sv, dp, dd);
          if (mask)
            pcap_rows<true, NS>(sv, dp, cl, l2, col0, lo, hi);
          else
            pcap_rows<false, NS>(sv, dp, cl, l2, col0, lo, hi);
        } else {
          wgmma_wait<1>();
          reg_fence(sv);
          if (mask)
            p_rows<true, NS>(sv, sc, l2, col0, lo, hi);
          else
            p_rows<false, NS>(sv, sc, l2, col0, lo, hi);
          wgmma_wait<0>();
          reg_fence(dp);
          ds_rows(sv, dp, dd);
        }
        uint32_t da[BN / 16][4];
        pack_a<NS>(da, dp);
        wgmma_fence();
        rs_tile<DQK, BN>(dq, da, ks);          // dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dq);
        reg_fence(da);
        release(empty(s), lane);
      }
      // epilogue: dQ scale in bf16 over this consumer's own Q rows, then a
      // TMA store (rows past S clipped); the slot goes back to the producer
      // once the store has read it
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      stage_out<DQK>(qa, BM, dq, scale, warp, lane);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      if (t == 0) {
#pragma unroll
        for (int c = 0; c < DQK / 64; ++c)
          tma_store(&dqmap, qa + c * BM * 128, 64 * c, h, r0, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(q_empty(slot));
      }
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// fp32 path (CUDA cores): 256 threads, thread (ty, tx) owning rows ty + 16 i
// and columns tx + 16 j (i, j < T / 16) of a T x T score tile, and output
// dims tx + 16 jj of its rows.  T is 64, or 32 at hd 256, where four 64-row
// fp32 tiles of 256 columns would take 257 KB of shared memory.
// ---------------------------------------------------------------------------
constexpr int SIMT_THREADS = 256;
template <int DQK>
struct SimtTile {
  static constexpr int T = DQK >= 256 ? 32 : 64;   // tile rows and columns
};

template <int HD, int T>
__device__ __forceinline__ void stage_f32(float* x, const float* src,
                                          size_t stride, int row0, int S) {
  for (int i = threadIdx.x; i < T * HD; i += SIMT_THREADS) {
    const int r = i / HD, d = i - r * HD, s = row0 + r;
    x[r * (HD + 1) + d] = s < S ? src[(size_t)s * stride + d] : 0.f;
  }
}

// c[i][j] = sum_d X[ty + 16 i][d] Y[tx + 16 j][d] over two staged tiles
template <int HD, int T>
__device__ __forceinline__ void tile_dot(float (&c)[T / 16][T / 16],
                                         const float* x, const float* y,
                                         int tx, int ty) {
  constexpr int R = T / 16;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float xv[R], yv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) xv[i] = x[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < R; ++j) yv[j] = y[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) c[i][j] = fmaf(xv[i], yv[j], c[i][j]);
  }
}

// acc[i][jj] += sum_c P[ty + 16 i][c] Z[c][tx + 16 jj]
template <int HD, int T>
__device__ __forceinline__ void tile_acc(float (&acc)[T / 16][HD / 16],
                                         const float* p, const float* z,
                                         int tx, int ty) {
  constexpr int R = T / 16;
#pragma unroll 4
  for (int c = 0; c < T; ++c) {
    float pv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) pv[i] = p[(ty + 16 * i) * (T + 1) + c];
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      const float zv = z[c * (HD + 1) + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i][jj] = fmaf(pv[i], zv, acc[i][jj]);
    }
  }
}

// two DQK-wide and two DV-wide staged tiles, a score tile and two rows of
// statistics
template <int DQK, int DV>
constexpr int simt_smem_bytes() {
  constexpr int T = SimtTile<DQK>::T;
  return (2 * T * (DQK + 1) + 2 * T * (DV + 1) + T * (T + 1) + 2 * T) * 4;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_bwd_dkdv_simt(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int Sq, int Sk, int H, int KH,
                    float scale, int causal, int window, float cap) {
  constexpr int T = SimtTile<DQK>::T, R = T / 16;
  constexpr int DJK = DQK / 16, DJV = DV / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                         // [T][DQK + 1]
  float* Qs = Ks + T * (DQK + 1);           // [T][DQK + 1]
  float* Vs = Qs + T * (DQK + 1);           // [T][DV + 1]
  float* Os = Vs + T * (DV + 1);            // dO, [T][DV + 1]
  float* Ps = Os + T * (DV + 1);            // [keys][queries]: P^T, then dS^T
  float* Ls = Ps + T * (T + 1);
  float* Ds = Ls + T;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int G = H / KH;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int k0 = blockIdx.x * T;
  const size_t qstride = (size_t)H * DQK, kstride = (size_t)KH * DQK;
  const size_t ostride = (size_t)H * DV, vstride = (size_t)KH * DV;
  const size_t k_off = (size_t)b * Sk * kstride + (size_t)kh * DQK;
  const size_t v_off = (size_t)b * Sk * vstride + (size_t)kh * DV;
  stage_f32<DQK, T>(Ks, k + k_off, kstride, k0, Sk);
  stage_f32<DV, T>(Vs, v + v_off, vstride, k0, Sk);

  float dk_acc[R][DJK], dv_acc[R][DJV];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int jj = 0; jj < DJK; ++jj) dk_acc[i][jj] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJV; ++jj) dv_acc[i][jj] = 0.f;
  }

  const int q_first = causal ? k0 : 0;
  const int q_end = window ? min(Sq, k0 + T - 1 + window) : Sq;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const size_t q_off = (size_t)b * Sq * qstride + (size_t)h * DQK;
    const size_t o_off = (size_t)b * Sq * ostride + (size_t)h * DV;
    const float* lse_h = lse + ((size_t)b * H + h) * Sq;
    const float* d_h = delta + ((size_t)b * H + h) * Sq;
    for (int q0 = (q_first / T) * T; q0 < q_end; q0 += T) {
      __syncthreads();
      stage_f32<DQK, T>(Qs, q + q_off, qstride, q0, Sq);
      stage_f32<DV, T>(Os, dout + o_off, ostride, q0, Sq);
      for (int i = tid; i < T; i += SIMT_THREADS) {
        Ls[i] = q0 + i < Sq ? lse_h[q0 + i] : 0.f;
        Ds[i] = q0 + i < Sq ? d_h[q0 + i] : 0.f;
      }
      __syncthreads();
      float s[R][R], dp[R][R];
      tile_dot<DQK, T>(s, Ks, Qs, tx, ty);  // S^T: keys ty.., queries tx..
      tile_dot<DV, T>(dp, Vs, Os, tx, ty);  // dP^T
      float ds[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int qi = tx + 16 * j;
          float x = s[i][j] * scale, dc = 1.f;
          if (cap != 0.f) {
            const float th = tanhf(x / cap);
            x = cap * th;
            dc = 1.f - th * th;
          }
          const float p =
              live_pair(q0 + qi, k0 + ty + 16 * i, Sq, Sk, causal, window)
                  ? expf(x - Ls[qi])
                  : 0.f;
          Ps[(ty + 16 * i) * (T + 1) + qi] = p;
          ds[i][j] = p * (dp[i][j] - Ds[qi]) * dc;
        }
      __syncthreads();
      tile_acc<DV, T>(dv_acc, Ps, Os, tx, ty);   // dV += P^T dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j)
          Ps[(ty + 16 * i) * (T + 1) + tx + 16 * j] = ds[i][j];
      __syncthreads();
      tile_acc<DQK, T>(dk_acc, Ps, Qs, tx, ty);  // dK += dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
#pragma unroll
    for (int jj = 0; jj < DJK; ++jj)
      dk[k_off + (size_t)key * kstride + tx + 16 * jj] =
          dk_acc[i][jj] * scale;
#pragma unroll
    for (int jj = 0; jj < DJV; ++jj)
      dv[v_off + (size_t)key * vstride + tx + 16 * jj] = dv_acc[i][jj];
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_bwd_dq_simt(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int Sq, int Sk, int H, int KH, float scale, int causal,
                  int window, float cap) {
  constexpr int T = SimtTile<DQK>::T, R = T / 16;
  constexpr int DJ = DQK / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                         // [T][DQK + 1]
  float* Ks = Qs + T * (DQK + 1);           // [T][DQK + 1]
  float* Os = Ks + T * (DQK + 1);           // dO, [T][DV + 1]
  float* Vs = Os + T * (DV + 1);            // [T][DV + 1]
  float* Ps = Vs + T * (DV + 1);            // [queries][keys]: dS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / KH);
  const int q0 = blockIdx.x * T;
  const size_t qstride = (size_t)H * DQK, kstride = (size_t)KH * DQK;
  const size_t ostride = (size_t)H * DV, vstride = (size_t)KH * DV;
  const size_t q_off = (size_t)b * Sq * qstride + (size_t)h * DQK;
  const size_t o_off = (size_t)b * Sq * ostride + (size_t)h * DV;
  const size_t k_off = (size_t)b * Sk * kstride + (size_t)kh * DQK;
  const size_t v_off = (size_t)b * Sk * vstride + (size_t)kh * DV;
  stage_f32<DQK, T>(Qs, q + q_off, qstride, q0, Sq);
  stage_f32<DV, T>(Os, dout + o_off, ostride, q0, Sq);

  float lse_r[R], d_r[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = q0 + ty + 16 * i;
    const size_t idx = ((size_t)b * H + h) * Sq + s;
    lse_r[i] = s < Sq ? lse[idx] : 0.f;
    d_r[i] = s < Sq ? delta[idx] : 0.f;
  }
  float dq_acc[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dq_acc[i][jj] = 0.f;

  const int k_first = window ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(Sk, q0 + T) : Sk;
  for (int t0 = (k_first / T) * T; t0 < k_end; t0 += T) {
    __syncthreads();
    stage_f32<DQK, T>(Ks, k + k_off, kstride, t0, Sk);
    stage_f32<DV, T>(Vs, v + v_off, vstride, t0, Sk);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<DQK, T>(s, Qs, Ks, tx, ty);    // S: rows ty.., keys tx..
    tile_dot<DV, T>(dp, Os, Vs, tx, ty);    // dP
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float x = s[i][j] * scale, dc = 1.f;
        if (cap != 0.f) {
          const float th = tanhf(x / cap);
          x = cap * th;
          dc = 1.f - th * th;
        }
        const float p =
            live_pair(q0 + ty + 16 * i, t0 + tx + 16 * j, Sq, Sk, causal,
                      window)
                ? expf(x - lse_r[i])
                : 0.f;
        Ps[(ty + 16 * i) * (T + 1) + tx + 16 * j] =
            p * (dp[i][j] - d_r[i]) * dc;
      }
    __syncthreads();
    tile_acc<DQK, T>(dq_acc, Ps, Ks, tx, ty);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= Sq) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      dq[q_off + (size_t)s * qstride + tx + 16 * jj] = dq_acc[i][jj] * scale;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
int launch_delta(const void* o, const void* dout, float* delta, int B, int S,
                 int H, int hd, cudaStream_t st) {
  const int rows = B * S * H;
  flash_bwd_delta<<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), delta,
      rows, S, H, hd);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver, looked up once per process
// through the runtime (no -lcuda at link time).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult st;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &st);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &st);
#endif
    return err == cudaSuccess && st == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A (B, S, heads, hd) bf16 tensor as a 4-D map, innermost first: (hd,
// heads, S, B), boxes of (64, 1, rows, 1) with the 128-byte swizzle that
// the wgmma descriptors read (64 rows but for MLA's 32-row Q and dO
// stages).  The box never crosses a batch row, so rows past S load as
// zeros and store nothing.
bool tensor_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int B,
                int S, int heads, int hd, int rows = 64) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raises a kernel's dynamic shared-memory limit to ``bytes`` once per
// (device, kernel): host calls at every launch cost time a short kernel
// shows.
cudaError_t allow_smem(const void* kernel, int bytes) {
  struct Entry {
    int dev;
    const void* fn;
    int bytes;
  };
  static Entry done[64];
  static int n_done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_done; ++i)
    if (done[i].dev == dev && done[i].fn == kernel && done[i].bytes >= bytes)
      return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && n_done < 64) done[n_done++] = {dev, kernel, bytes};
  return err;
}

// The plan as the kernels were compiled for it: tile sizes, a ring of at
// least one slot and stage, regions inside the block's shared memory.
template <int DQK, int DV, bool CAP>
bool plan_fits(const BwdPlan& p) {
  using Tile = BwdTile<DQK, DV, CAP>;
  constexpr int BR = Tile::BR, BN = Tile::BN, BC = Tile::BC, W = DQK + DV;
  constexpr int DQ_SLOT = BM * (DQK + (Tile::O_SMEM ? 2 : 1) * DV) * 2;
  const int kv_bar =
      p.kv_off_bars + 8 * 2 * (p.kv_slots + p.kv_stages + p.kv_hands);
  const int dq_bar = p.dq_off_bars + 8 * 2 * (p.dq_slots + p.dq_stages);
  return p.br == BR && p.bc == BC && p.bm == BM && p.bn == BN &&
         p.s_pad % BM == 0 && p.kv_slots >= 1 && p.kv_stages >= 1 &&
         p.dq_slots >= 1 && p.dq_stages >= 1 && p.kv_blocks >= 1 &&
         p.dq_blocks >= 1 && p.kv_split >= 1 &&
         (Tile::SPLIT || p.kv_split == 1) &&
         (Tile::SPLIT ? p.kv_hands >= 1 : p.kv_hands == 0) &&
         p.kv_off_ring >= p.kv_off_kv + p.kv_slots * BC * W * 2 &&
         p.kv_off_stats >= p.kv_off_ring + p.kv_stages * BR * W * 2 &&
         p.kv_off_hand >= p.kv_off_stats + p.kv_stages * BR * 8 &&
         p.kv_off_hand % 16 == 0 &&
         p.kv_off_bars >= p.kv_off_hand + p.kv_hands * BC * BR * 4 &&
         p.dq_off_ring >= p.dq_off_q + p.dq_slots * DQ_SLOT &&
         p.dq_off_bars >= p.dq_off_ring + p.dq_stages * BN * W * 2 &&
         kv_bar + 1023 <= p.kv_smem && dq_bar + 1023 <= p.dq_smem &&
         p.kv_smem <= SMEM_LIMIT && p.dq_smem <= SMEM_LIMIT;
}

template <int DQK, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const float* lse, const void* dout, void* dq, void* dk,
                 void* dv, float* stats, int B, int Sq, int Sk, int H,
                 int KH, float scale, int causal, int window, float cap,
                 const BwdPlan& p, const int* work, cudaStream_t st) {
  using Plain = BwdTile<DQK, DV, false>;
  const bool c = cap != 0.f;
  // MLA's pair is compiled without the softcap (no config trains it with one)
  if (DQK != DV && c) return -1;
  if (!(c ? plan_fits<DQK, DV, true>(p) : plan_fits<DQK, DV, false>(p)))
    return -1;
  if (Plain::SPLIT && (H / KH) % p.kv_split != 0) return -1;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  // the dK/dV kernel's Q and dO stages come in boxes of QBOX rows, the dQ
  // kernel's K and V stages in boxes of KBOX keys
  const int qbox = c ? BwdTile<DQK, DV, true>::QBOX : Plain::QBOX;
  const int kbox = c ? BwdTile<DQK, DV, true>::KBOX : Plain::KBOX;
  CUtensorMap qm, dm, qrm, drm, om, km, vm, kqm, vqm, dqm, dkm, dvm;
  if (!tensor_map(enc, &qm, q, B, Sq, H, DQK) ||
      !tensor_map(enc, &dm, dout, B, Sq, H, DV) ||
      !tensor_map(enc, &qrm, q, B, Sq, H, DQK, qbox) ||
      !tensor_map(enc, &drm, dout, B, Sq, H, DV, qbox) ||
      !tensor_map(enc, &om, o, B, Sq, H, DV) ||
      !tensor_map(enc, &km, k, B, Sk, KH, DQK) ||
      !tensor_map(enc, &vm, v, B, Sk, KH, DV) ||
      !tensor_map(enc, &kqm, k, B, Sk, KH, DQK, kbox) ||
      !tensor_map(enc, &vqm, v, B, Sk, KH, DV, kbox) ||
      !tensor_map(enc, &dqm, dq, B, Sq, H, DQK) ||
      !tensor_map(enc, &dkm, dk, B, Sk, KH, DQK) ||
      !tensor_map(enc, &dvm, dv, B, Sk, KH, DV))
    return (int)cudaErrorInvalidValue;     // e.g. a base not 16-byte aligned
  float2* stats2 = reinterpret_cast<float2*>(stats);
  // log2 units: 2^(x log2 e) = e^x; under a softcap th = tanh(s scale / cap)
  // and the score in log2 units is th cap log2 e
  const float sc = c ? scale / cap : scale * LOG2E;
  const float cl = cap * LOG2E;
  auto dkdv = flash_bwd_dkdv_wgmma<DQK, DV, false>;
  auto dqk = flash_bwd_dq_wgmma<DQK, DV, false>;
  if constexpr (DQK == DV)
    if (c) {
      dkdv = flash_bwd_dkdv_wgmma<DQK, DV, true>;
      dqk = flash_bwd_dq_wgmma<DQK, DV, true>;
    }
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(dkdv),
                               p.kv_smem);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(reinterpret_cast<const void*>(dqk), p.dq_smem);
  if (err != cudaSuccess) return (int)err;
  // dQ first: it writes the statistics the dK/dV kernel streams
  dqk<<<p.dq_blocks, WG_THREADS, p.dq_smem, st>>>(
      qm, dm, om, kqm, vqm, dqm, lse, stats2, work, p, Sq, Sk, H, KH, sc, cl,
      scale, causal, window, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // hd 256: the dK/dV partials follow the statistics in the scratch
  float* part = stats + (size_t)B * H * p.s_pad * 2;
  dkdv<<<p.kv_blocks, WG_THREADS, p.kv_smem, st>>>(
      qrm, drm, km, vm, dkm, dvm, stats2, work, p, B, Sq, Sk, H, KH, sc, cl,
      scale, causal, window, part);
  err = cudaGetLastError();
  if (err != cudaSuccess || !Plain::SPLIT) return (int)err;
  const size_t n = (size_t)B * Sk * KH * DQK;
  flash_bwd_dkdv_sum<<<(unsigned)((2 * n / 4 + 255) / 256), 256, 0, st>>>(
      part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), p.kv_split, n,
      scale);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_simt(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, void* dk,
                void* dv, int B, int Sq, int Sk, int H, int KH, float scale,
                int causal, int window, float cap, cudaStream_t st) {
  const int bytes = simt_smem_bytes<DQK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_simt<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_simt<DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int T = SimtTile<DQK>::T;
  const int k_tiles = (Sk + T - 1) / T, q_tiles = (Sq + T - 1) / T;
  const float *qp = static_cast<const float*>(q),
              *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v),
              *op = static_cast<const float*>(dout);
  flash_bwd_dkdv_simt<DQK, DV>
      <<<dim3(k_tiles, B * KH), SIMT_THREADS, bytes, st>>>(
          qp, kp, vp, op, lse, delta, static_cast<float*>(dk),
          static_cast<float*>(dv), Sq, Sk, H, KH, scale, causal, window, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_simt<DQK, DV>
      <<<dim3(q_tiles, B * H), SIMT_THREADS, bytes, st>>>(
          qp, kp, vp, op, lse, delta, static_cast<float*>(dq), Sq, Sk, H, KH,
          scale, causal, window, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, dq: (B, S, H, hd); o, dout: (B, S,
// H, hdv); k, dk: (B, Sk, KH, hd); v, dv: (B, Sk, KH, hdv), Sk != S without
// a causal mask or a window only (cross-attention); (hd, hdv) is (64,
// 64), (128, 128), (256, 256) or MLA's (192, 128); the last takes no
// softcap in bf16.  lse: (B, H, S) fp32 (natural log); delta: fp32 scratch
// that this call fills, (B, H, S) floats for fp32 and (B, H, s_pad, 2) for
// bf16, followed at hd 256 by 2 kv_split B Sk KH 256 floats of partials.  plan: ``n_plan`` ints
// in host memory, the fields of BwdPlan
// (kernels/flash_attention.py:flash_bwd_plan), and work: the plan's work
// items and block starts on the card; the bf16 route reads both, the fp32
// route neither.  All contiguous; bf16 operands 16-byte aligned.  Returns
// 0 when every kernel was launched, a CUDA error code when a launch was
// refused, -1 for an unsupported shape, type or plan.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* lse,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* delta, int dtype, int B,
                                   int S, int Sk, int H, int KH, int hd,
                                   int hdv,
                                   float scale, int causal, int window,
                                   float cap, void* stream, const int* plan,
                                   int n_plan, const void* work) {
  if (B <= 0 || S <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0 || window < 0)
    return -1;
  if (Sk != S && (causal || window)) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  if (!((hd == 64 && hdv == 64) || (hd == 128 && hdv == 128) ||
        (hd == 256 && hdv == 256) || (hd == 192 && hdv == 128)))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  BwdPlan p;
  if (dtype == 1) {
    if (plan == nullptr || n_plan != BWD_PLAN_INTS || work == nullptr)
      return -1;
    memcpy(&p, plan, sizeof(BwdPlan));
  } else {
    const int rc = launch_delta(o, dout, dp, B, S, H, hdv, st);
    if (rc) return rc;
  }
  const int* w = static_cast<const int*>(work);
#define FLASH_BWD_CASE(DQK, DV)                                               \
  if (hd == DQK && hdv == DV)                                                 \
    return dtype == 0                                                         \
               ? launch_simt<DQK, DV>(q, k, v, dout, lp, dp, dq, dk, dv, B, S, \
                                      Sk, H, KH, scale, causal, window, cap,  \
                                      st)                                     \
               : launch_wgmma<DQK, DV>(q, k, v, o, lp, dout, dq, dk, dv, dp,  \
                                       B, S, Sk, H, KH, scale, causal,        \
                                       window, cap, p, w, st);
  FLASH_BWD_CASE(64, 64)
  FLASH_BWD_CASE(128, 128)
  FLASH_BWD_CASE(256, 256)
  FLASH_BWD_CASE(192, 128)
#undef FLASH_BWD_CASE
  return -1;
}
