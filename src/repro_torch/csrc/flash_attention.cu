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
// Query positions 0..S-1 attend to key positions 0..Sk-1 (Sk != S only
// without a causal mask or a window: cross-attention, where the entry
// point refuses the others).  Keys past Sk are masked, so neither length
// need be a multiple of any tile.  The
// TPU walked kv blocks as a sequential grid axis with (m, l, acc) in VMEM
// scratch; here a loop inside the thread block replaces that axis, and kv
// tiles beyond the causal frontier or before the window are never loaded.
//
// Two instantiations of that walk:
//
// * bf16 (the serving and training path; hd 64, 128, 256, and MLA's q and
//   k 192 wide over v 128, a template of two widths): a persistent,
//   warp-specialised kernel of three warpgroups, one block an SM.  A work
//   item is a 128-row q tile of one (b, h); a block walks its items longest
//   first (a static zig-zag over the grid).  Warpgroup 0 is the producer:
//   after setmaxnreg gives its registers away (24 a thread), one thread
//   issues every load as a TMA copy of a 4-D tensor map (hd, heads, S, B)
//   in boxes of 64 hd columns with the 128-byte swizzle: an item's Q, then
//   its K and V tiles (128 keys, 64 at hd 256) through a ring of full/empty
//   mbarriers (3 stages at hd 64, 2 above) whose stage and phase run on
//   across items.  Rows past S arrive as zeros.  Warpgroups 1 and 2 are
//   the consumers (240 registers a thread), 64 q rows each: S = Q K^T is
//   wgmma with both operands in shared memory (K-major), O += P V is wgmma
//   with P from registers (the score accumulator rounded to bf16 is the A
//   fragment) and V MN-major (the transpose-B bit).  Each consumer issues
//   tile i's S product before tile i-1's P V product and runs tile i's
//   softmax while P V is in flight; a stage goes back to the producer only
//   after the wgmma that read it has completed.  The two consumers also
//   take turns to issue (ping-pong, named barriers), so one runs its
//   softmax under the other's products.  The softmax works in
//   log2 units (scores times scale * log2 e, ex2.approx); only the tiles on
//   the causal diagonal, at the window's edge or past S compute a mask,
//   and the softcap is a template flag.  The epilogue writes bf16 O to a
//   staging buffer in shared memory and TMA-stores it (rows past S are
//   clipped) while the block goes on.  The probabilities are rounded to bf16
//   for the P V product (the plain version keeps fp32 P; the difference is
//   within the stated tolerance).
// * fp32 (exactness checks): the same walk on the CUDA cores in fp32, 256
//   threads, thread (ty, tx) owning q rows ty + 16 i and keys tx + 16 j
//   (i, j < 4) of the score tile and output dims tx + 16 jj of its rows.
//
// Training passes an lse buffer (B, H, S) fp32 and both walks also write
// each row's softmax log-sum-exp in natural units, the statistic the
// backward (csrc/flash_attention_bwd.cu) recomputes P from.  The bf16 walk
// keeps its running max in log2 units of scale * log2 e, so its lse is
// max * ln 2 + ln l; the fp32 walk's max is already natural.  Serving
// passes null: no store, the same work as before.
//
// Bound on the card: a causal prefill does 4 * hd FLOPs per live (q, k)
// pair (two products; 2 (192 + 128) for MLA); against 989 TFLOP/s (bf16
// tensor cores, H100 SXM)
// that is the bound at the serving shapes, while q, k, v and o are read or
// written once (bytes / 3.35 TB/s).  The exponentials are the next limit:
// one MUFU op per pair at 16 a clock per SM, half the tensor-core time of
// a pair at hd 128 and as much at hd 64.
//
// cuTensorMapEncodeTiled comes from the driver through the runtime's
// cudaGetDriverEntryPoint(ByVersion), so the library links no -lcuda.

#include <cuda.h>
#include <algorithm>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block of the fp32 path
constexpr int BKV = 64;         // keys per kv tile of the fp32 path
constexpr int NT = 256;         // threads per block of the fp32 path
constexpr float NEG_INF = -2.0e38f;

// ---------------------------------------------------------------------------
// fp32 path (CUDA cores)
// ---------------------------------------------------------------------------

template <int DQK, int DV>
constexpr int smem_floats() {
  return BQ * (DQK + 1) + BKV * (DQK + 1) + BKV * DV + BQ * (BKV + 1);
}

// q, k: DQK wide; v, o: DV wide (equal but for MLA's 192 / 128)
template <int DQK, int DV>
__global__ void __launch_bounds__(NT)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int S, int Sk, int H, int KH,
               float scale, int causal, int window, float cap) {
  constexpr int DJ = DV / 16;               // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;                         // [BQ][DQK + 1], scaled
  float* Ks = Qs + BQ * (DQK + 1);          // [BKV][DQK + 1]
  float* Vs = Ks + BKV * (DQK + 1);         // [BKV][DV]
  float* Ps = Vs + BKV * DV;                // [BQ][BKV + 1]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = blockIdx.y * BQ;
  const size_t qstride = (size_t)H * DQK, kstride = (size_t)KH * DQK;
  const size_t vstride = (size_t)KH * DV, ostride = (size_t)H * DV;
  const float* qb = q + (size_t)b * S * qstride + (size_t)h * DQK;
  const float* kb = k + (size_t)b * Sk * kstride + (size_t)kh * DQK;
  const float* vb = v + (size_t)b * Sk * vstride + (size_t)kh * DV;
  float* ob = o + (size_t)b * S * ostride + (size_t)h * DV;

  for (int idx = tid; idx < BQ * DQK; idx += NT) {
    const int r = idx / DQK, d = idx - r * DQK, s = q0 + r;
    Qs[r * (DQK + 1) + d] =
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
  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int kv_begin = window ? (max(0, q0 - window + 1) / BKV) * BKV : 0;

  for (int t0 = kv_begin; t0 < kv_end; t0 += BKV) {
    __syncthreads();  // Q staged; the previous tile's K, V, P consumed
    for (int idx = tid; idx < BKV * DQK; idx += NT) {
      const int r = idx / DQK, d = idx - r * DQK, t = t0 + r;
      Ks[r * (DQK + 1) + d] = t < Sk ? kb[(size_t)t * kstride + d] : 0.f;
    }
    for (int idx = tid; idx < BKV * DV; idx += NT) {
      const int r = idx / DV, d = idx - r * DV, t = t0 + r;
      Vs[r * DV + d] = t < Sk ? vb[(size_t)t * vstride + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (DQK + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (DQK + 1) + d];
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
        bool ok = pk < Sk;
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
        const float vv = Vs[t * DV + tx + 16 * jj];
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
    if (lse != nullptr && tx == 0)          // m is in natural units here
      lse[((size_t)b * H + h) * S + row] = m[i] + logf(denom);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      ob[(size_t)row * ostride + tx + 16 * jj] = acc[i][jj] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16 path: TMA, mbarriers, wgmma, one producer and two consumer warpgroups
// ---------------------------------------------------------------------------
constexpr int WG_BQ = 128;              // q rows per block (64 per consumer)
constexpr int WG_THREADS = 384;         // producer + two consumer warpgroups
// setmaxnreg: (24 + 2 x 240) x 128 = 64,512 of the SM's 65,536 registers
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// keys per kv tile and ring depth: at a v width of 256 a thread's output
// accumulator is 128 registers, so the score tile is 64 keys (32 more).
// q and k are DQK wide, v and o DV wide: equal, but for MLA's 192 / 128.
template <int DQK, int DV>
struct WgTile {
  static constexpr int BKV = DV > 128 ? 64 : 128;
  static constexpr int STAGES = DQK > 64 ? 2 : 3;
  static constexpr int Q_BYTES = WG_BQ * DQK * 2;
  static constexpr int K_BYTES = BKV * DQK * 2;          // one K tile
  static constexpr int V_BYTES = BKV * DV * 2;           // one V tile
  static constexpr int RING = Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  // the epilogue stages O in boxes of 64 rows x 64 columns, up to 128
  // columns a consumer at a time (224 KB in all at hd 256), 64 where 128
  // would not fit (MLA: Q 48 KB and two stages of K and V, 160 KB, leave
  // 16 KB of the 227 for O)
  static constexpr int O_WIDE = DV < 128 ? DV : 128;
  static constexpr int O_COLS =
      RING + 2 * 64 * O_WIDE * 2 + 8 * (2 + 4 * STAGES) + 1024 <= 232448
          ? O_WIDE
          : 64;
  static constexpr int O_BYTES = 2 * 64 * O_COLS * 2;
  static constexpr int BAR_OFF = RING + O_BYTES;
  // q_full, q_empty, then k_full, k_empty, v_full, v_empty per stage
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 4 * STAGES) + 1024;
  static_assert(SMEM <= 232448, "flash forward: shared memory");
};

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

// One box (64 columns of hd, 1 head, rows, 1 batch row) of a 4-D tensor map
// into shared memory; rows past S arrive as zeros.
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
// operand whose N spans several of them (V).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[OFF .. OFF + 32) (+)= A (64 x 16, shared, K-major) . B (16 x 64, shared,
// K-major); scale_d 0 overwrites d.
template <int OFF, int T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[T], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]),
        "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]),
        "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[OFF .. OFF + 64) (+)= A (64 x 16, shared, K-major) . B (16 x 128, shared,
// K-major); scale_d 0 overwrites d.
template <int OFF, int T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[T], uint64_t da,
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
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]),
        "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]),
        "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]),
        "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]),
        "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
        "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]),
        "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]),
        "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
        "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]),
        "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]),
        "+f"(d[OFF + 63])
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
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]),
        "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]),
        "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
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
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]),
        "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]),
        "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]),
        "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]),
        "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
        "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]),
        "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]),
        "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
        "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]),
        "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]),
        "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T for one consumer's 64 rows and a kv tile: HD / 16 k-steps
// (HD the qk width: 12 at MLA's 192).
// Within a 128-byte swizzle atom a k-step advances the start address by
// 32 bytes; every 4 k-steps move to the next 64-column block.
template <int HD, int BKV>
__device__ __forceinline__ void qk_product(float (&s)[BKV / 2], uint32_t qa,
                                           uint32_t kb) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint64_t da =
        sw128_desc(qa + (ks >> 2) * WG_BQ * 128 + (ks & 3) * 32, 16);
    const uint64_t db =
        sw128_desc(kb + (ks >> 2) * BKV * 128 + (ks & 3) * 32, 16);
    if constexpr (BKV == 128)
      wgmma_ss_n128<0>(s, da, db, ks > 0);
    else
      wgmma_ss_n64<0>(s, da, db, ks > 0);
  }
}

// O += P V: P (bf16) from registers, V MN-major from shared memory; a
// k-step is 16 keys (2,048 bytes of a column block), and n spans HD columns
// (HD the v width; column blocks BKV * 128 bytes apart), at most 128 an
// instruction.
template <int HD, int BKV>
__device__ __forceinline__ void pv_product(float (&o)[HD / 2],
                                           const uint32_t (&p)[BKV / 16][4],
                                           uint32_t vb) {
  constexpr uint32_t LBO = BKV * 128;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint32_t a = vb + kk * 16 * 128;
    if constexpr (HD == 64) {
      wgmma_rs_n64<0>(o, p[kk], sw128_desc(a, LBO));
    } else {
      wgmma_rs_n128<0>(o, p[kk], sw128_desc(a, LBO));
      if constexpr (HD == 256)
        wgmma_rs_n128<64>(o, p[kk], sw128_desc(a + 2 * LBO, LBO));
    }
  }
}

// 2^x on the MUFU unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// What a consumer's softmax needs to know about its rows and the tile.
struct RowCtx {
  int Sk, causal, window;
  int row0;      // this thread's first row (absolute); the second is +8
  int key0;      // the tile's first key plus 2 * (lane % 4)
  float sc;      // softcap: scale / cap; else scale * log2(e)
  float cl;      // softcap: cap * log2(e)
};

// The online softmax of one score tile, in place: s becomes p =
// 2^(x - m) with x the scaled (softcapped) score in log2 units and m the
// running row max, in those units.  ``corr`` is what the running sums and
// the output must be multiplied by, ``rs`` this tile's row sums (of this
// thread's columns; the quad is reduced at the end).  MASK: some key of the
// tile is dead for some row (the causal diagonal, the window's edge, keys
// past Sk); elsewhere every key is live and no mask is computed.  A masked
// score is NEG_INF, finite.  While a row has seen no live key its max is
// NEG_INF, and its p are taken against 0 (so they are 0, not 2^0): the
// exponent is one fma, s k - m k, and with both products near 1e37 its
// rounding alone would be about 1e30.
template <int NS, bool MASK, bool CAP>
__device__ __forceinline__ void online_softmax(float (&s)[NS], float (&m)[2],
                                               float (&rs)[2],
                                               float (&corr)[2],
                                               const RowCtx& c) {
  const float k = CAP ? 1.f : c.sc;    // raw score -> log2 units
  float mx[2] = {m[0], m[1]};
  // row r's live keys, as columns of this thread relative to key0
  // (lo..hi); one row at a time, so that two registers hold the bounds
  // (four spilled at hd 256, where the output takes 128 of the 240)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int lo = 0, hi = 0;
    if constexpr (MASK) {
      const int row = c.row0 + 8 * r;
      hi = (c.causal ? min(row, c.Sk - 1) : c.Sk - 1) - c.key0;
      lo = c.window ? row - c.window + 1 - c.key0 : -(1 << 30);
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (((i >> 1) & 1) != r) continue;
      float x = s[i];
      if constexpr (CAP) x = c.cl * tanhf(x * c.sc);
      if constexpr (MASK) {
        const int col = 8 * (i >> 2) + (i & 1);
        x = col <= hi && col >= lo ? x : NEG_INF;
      }
      s[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2((m[r] - mx[r]) * k);
    m[r] = mx[r];
    rs[r] = 0.f;
  }
  const float mk[2] = {m[0] == NEG_INF ? 0.f : m[0] * k,
                       m[1] == NEG_INF ? 0.f : m[1] * k};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(fmaf(s[i], k, -mk[r]));
    s[i] = p;
    rs[r] += p;
  }
}

template <int NS, bool CAP>
__device__ __forceinline__ void softmax_tile(bool mask, float (&s)[NS],
                                             float (&m)[2], float (&rs)[2],
                                             float (&corr)[2],
                                             const RowCtx& c) {
  if (mask)
    online_softmax<NS, true, CAP>(s, m, rs, corr, c);
  else
    online_softmax<NS, false, CAP>(s, m, rs, corr, c);
}

// The fp32 probabilities of the score accumulator, as the bf16 A fragments
// of the P V k-steps: the accumulators of key columns 16 kk .. 16 kk + 15
// are exactly the A fragment of k-step kk.
template <int NS>
__device__ __forceinline__ void pack_p(uint32_t (&p)[NS / 8][4],
                                       const float (&s)[NS]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// A block's work items: the (b, h, 128-row q tile) triples in order of
// length, longest q tiles first; block c of G takes items c, 2G - 1 - c,
// 2G + c, ... (a zig-zag, so the long and the short even out).
struct WorkItem {
  int b, h, q0, t_lo, n_tiles;     // kv tiles t_lo .. t_lo + n_tiles - 1
};

template <int BKV>
__device__ __forceinline__ WorkItem work_item(int w, int B, int S, int Sk,
                                              int H, int causal,
                                              int window) {
  const int n_qt = (S + WG_BQ - 1) / WG_BQ;
  WorkItem u;
  const int bh = w % (B * H);
  u.b = bh / H;
  u.h = bh % H;
  u.q0 = (n_qt - 1 - w / (B * H)) * WG_BQ;
  const int kv_end = causal ? min(Sk, u.q0 + WG_BQ) : Sk;
  u.t_lo = window ? max(0, u.q0 - window + 1) / BKV : 0;
  u.n_tiles = (kv_end - 1) / BKV - u.t_lo + 1;
  return u;
}

__device__ __forceinline__ int work_index(int r) {
  const int G = gridDim.x, c = blockIdx.x;
  return r * G + ((r & 1) ? G - 1 - c : c);
}

// Persistent: one block an SM walks its work items.  Warpgroup 0 is the
// producer (one thread issues every TMA load), warpgroups 1 and 2 are the
// consumers, each owning 64 of an item's 128 q rows.  Both consumers walk
// the same kv tiles, from the window's start up to the causal frontier
// (so the masked diagonal tile comes last, its softmax under the P V
// product of the tile before), and the ring's barriers see the same
// arrivals from both each round; the ring's stage and phase run on across
// items, and the next item's Q and first tiles load while the consumers
// finish the last one.
template <int DQK, int DV, bool CAP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap omap,
                float* __restrict__ lse, int B, int S, int Sk, int H,
                int KH, float sc, float cl, int causal, int window) {
  using T = WgTile<DQK, DV>;
  constexpr int BKV = T::BKV, ST = T::STAGES, NS = BKV / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + T::Q_BYTES;
  const uint32_t v_s = k_s + ST * T::K_BYTES;
  const uint32_t o_s = v_s + ST * T::V_BYTES;
  const uint32_t bars = base + T::BAR_OFF;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8 * (2 + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 + ST + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 + 2 * ST + s); };
  auto v_empty = [&](int s) { return bars + 8 * (2 + 3 * ST + s); };
  const int n_work = B * H * ((S + WG_BQ - 1) / WG_BQ);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);                 // one arrival per consumer warp
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: per item Q, then K_0, (K_i, V_{i-1}) ..., V_last ------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int it = 0;                          // kv tiles loaded so far
      for (int r = 0;; ++r) {
        const int w = work_index(r);
        if (w >= n_work) break;
        const WorkItem u = work_item<BKV>(w, B, S, Sk, H, causal, window);
        const int kh = u.h / (H / KH);
        mbar_wait(q_empty, (r & 1) ^ 1);   // item 0 passes at once
        mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
        for (int c = 0; c < DQK / 64; ++c)
          tma_load(q_s + c * WG_BQ * 128, &qmap, q_full, 64 * c, u.h, u.q0,
                   u.b);
        for (int i = 0; i <= u.n_tiles; ++i) {
#pragma unroll
          for (int kv = 0; kv < 2; ++kv) {
            const int j = i - kv;          // K_i, then V_{i-1}
            if (j < 0 || j >= u.n_tiles) continue;
            const int n = it + j, s = n % ST;
            const uint32_t full = kv ? v_full(s) : k_full(s);
            mbar_wait(kv ? v_empty(s) : k_empty(s), ((n / ST) & 1) ^ 1);
            mbar_expect_tx(full, kv ? T::V_BYTES : T::K_BYTES);
            const uint32_t dst =
                kv ? v_s + s * T::V_BYTES : k_s + s * T::K_BYTES;
            const int n_boxes = (kv ? DV : DQK) / 64;
            for (int c = 0; c < n_boxes; ++c)
              tma_load(dst + c * BKV * 128, kv ? &vmap : &kmap, full, 64 * c,
                       kh, (u.t_lo + j) * BKV, u.b);
          }
        }
        it += u.n_tiles;
      }
    }
  } else {
    // ---- consumers -------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;                       // consumer 0 or 1
    const int t = threadIdx.x - 128 * wg;        // thread in the warpgroup
    const int warp = t >> 5, lane = t & 31;
    const uint32_t qa = q_s + 64 * cw * 128;     // this consumer's Q rows
    // ping-pong: the consumers take turns to issue their products (named
    // barriers 3 and 4), so one's softmax runs under the other's wgmma;
    // consumer 1 passes the first turn and keeps its last
    auto turn_wait = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + cw) : "memory");
    };
    auto turn_pass = [&](bool last) {
      if (!(last && cw == 1))
        asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - cw) : "memory");
    };
    if (cw == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    // a warp's release of a barrier, once its wgmma reads are complete
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    float o_acc[DV / 2], s[NS];
    uint32_t p[BKV / 16][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    int it = 0;                                  // kv tiles consumed so far
    for (int r = 0;; ++r) {
      const int w = work_index(r);
      if (w >= n_work) break;
      const bool last_item = work_index(r + 1) >= n_work;
      const WorkItem u = work_item<BKV>(w, B, S, Sk, H, causal, window);
      const int q0c = u.q0 + 64 * cw;
      RowCtx ctx{Sk, causal, window, q0c + 16 * warp + (lane >> 2), 0, sc,
                 cl};
      // a tile needs a mask iff some key of it is dead for some row of the
      // consumer's 64: past Sk, past the causal diagonal, before the window
      auto masked = [&](int t0) {
        return t0 + BKV > Sk || (causal && t0 + BKV - 1 > q0c) ||
               (window && q0c + 63 - t0 >= window);
      };
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o_acc[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, rs[2], corr[2];

      mbar_wait(q_full, r & 1);
      // tile 0: S, softmax, P
      {
        const int sk = it % ST;
        mbar_wait(k_full(sk), (it / ST) & 1);
        turn_wait();
        wgmma_fence();
        qk_product<DQK, BKV>(s, qa, k_s + sk * T::K_BYTES);
        wgmma_commit();
        turn_pass(false);
        wgmma_wait<0>();
        reg_fence(s);
        release(k_empty(sk));
        if (u.n_tiles == 1) release(q_empty);
        ctx.key0 = u.t_lo * BKV + 2 * (lane & 3);
        softmax_tile<NS, CAP>(masked(u.t_lo * BKV), s, m, rs, corr, ctx);
        l[0] = rs[0];
        l[1] = rs[1];
        pack_p<NS>(p, s);
      }
      // tile i: S_i = Q K_i is issued, then O += P_{i-1} V_{i-1}; the
      // softmax of S_i runs while the P V product is in flight
      for (int i = 1; i < u.n_tiles; ++i) {
        const int nk = it + i, sk = nk % ST, sv = (nk - 1) % ST;
        const int t0 = (u.t_lo + i) * BKV;
        mbar_wait(k_full(sk), (nk / ST) & 1);
        mbar_wait(v_full(sv), ((nk - 1) / ST) & 1);
        turn_wait();
        wgmma_fence();
        qk_product<DQK, BKV>(s, qa, k_s + sk * T::K_BYTES);
        wgmma_commit();
        pv_product<DV, BKV>(o_acc, p, v_s + sv * T::V_BYTES);
        wgmma_commit();
        turn_pass(false);
        wgmma_wait<1>();
        reg_fence(s);
        release(k_empty(sk));
        if (i == u.n_tiles - 1) release(q_empty);
        ctx.key0 = t0 + 2 * (lane & 3);
        softmax_tile<NS, CAP>(masked(t0), s, m, rs, corr, ctx);
        wgmma_wait<0>();
        reg_fence(o_acc);
        reg_fence(p);
        release(v_empty(sv));
#pragma unroll
        for (int j = 0; j < DV / 2; ++j) o_acc[j] *= corr[(j >> 1) & 1];
        l[0] = l[0] * corr[0] + rs[0];
        l[1] = l[1] * corr[1] + rs[1];
        pack_p<NS>(p, s);
      }
      {
        const int nv = it + u.n_tiles - 1, sv = nv % ST;
        mbar_wait(v_full(sv), (nv / ST) & 1);
        turn_wait();
        wgmma_fence();
        pv_product<DV, BKV>(o_acc, p, v_s + sv * T::V_BYTES);
        wgmma_commit();
        turn_pass(last_item);
        wgmma_wait<0>();
        reg_fence(o_acc);
        release(v_empty(sv));
      }
      it += u.n_tiles;

      // epilogue: o / max(l, 1e-37) in bf16 through shared memory and TMA
      // stores, which clip the rows past S
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
        const float denom = fmaxf(l[rr], 1e-37f);
        // the log-sum-exp in natural units: m * (CAP ? 1 : sc) is the row
        // max in log2 units, so lse = that * ln 2 + ln l
        const int row = q0c + 16 * warp + (lane >> 2) + 8 * rr;
        if (lse != nullptr && (lane & 3) == 0 && row < S)
          lse[((size_t)u.b * H + u.h) * S + row] =
              m[rr] * (CAP ? 1.f : sc) * LN2 + logf(denom);
        l[rr] = 1.f / denom;
      }
      // this consumer's staging buffer holds O_COLS columns in the box's
      // swizzled layout; it is reused once the last stores have read it
      const uint32_t os = o_s + cw * 64 * T::O_COLS * 2;
      const int g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int ch = 0; ch < DV / T::O_COLS; ++ch) {
        if (t == 0)
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
#pragma unroll
        for (int jl = 0; jl < T::O_COLS / 8; ++jl) {
          const int j = ch * (T::O_COLS / 8) + jl;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int row = 16 * warp + g + 8 * rr;
            const uint32_t addr = os + (jl >> 3) * 64 * 128 + row * 128 +
                                  (((jl & 7) ^ (row & 7)) << 4) + 4 * tq;
            const uint32_t v = pack_bf16(o_acc[4 * j + 2 * rr] * l[rr],
                                         o_acc[4 * j + 2 * rr + 1] * l[rr]);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v)
                         : "memory");
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
        if (t == 0) {
#pragma unroll
          for (int c = 0; c < T::O_COLS / 64; ++c)
            tma_store(&omap, os + c * 64 * 128,
                      ch * T::O_COLS + 64 * c, u.h, q0c, u.b);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
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
// the wgmma descriptors read.  The box never crosses a batch row, so rows
// past S load as zeros and store nothing.
bool tensor_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int B,
                int S, int heads, int hd, int rows) {
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

template <int DQK, int DV>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int Sk, int H, int KH, float scale,
                int causal, int window, float cap, cudaStream_t stream) {
  const int smem = smem_floats<DQK, DV>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_simt<DQK, DV><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Sk, H,
      KH, scale, causal, window, cap);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int S, int Sk, int H, int KH, float scale,
                 int causal, int window, float cap, cudaStream_t stream) {
  using T = WgTile<DQK, DV>;
  // MLA's pair is compiled without the softcap (no config has both)
  if (DQK != DV && cap != 0.f) return -1;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qm, km, vm, om;
  if (!tensor_map(enc, &qm, q, B, S, H, DQK, WG_BQ) ||
      !tensor_map(enc, &km, k, B, Sk, KH, DQK, T::BKV) ||
      !tensor_map(enc, &vm, v, B, Sk, KH, DV, T::BKV) ||
      !tensor_map(enc, &om, o, B, S, H, DV, 64))
    return (int)cudaErrorInvalidValue;     // e.g. a base not 16-byte aligned
  auto kernel = flash_fwd_wgmma<DQK, DV, false>;
  if constexpr (DQK == DV)
    if (cap != 0.f) kernel = flash_fwd_wgmma<DQK, DV, true>;
  // log2 units: 2^(x log2 e) = e^x
  const float sc = cap != 0.f ? scale / cap : scale * LOG2E;
  const float cl = cap * LOG2E;
  // per device, queried once: its SM count (the persistent grid) and
  // whether this instantiation's shared-memory limit is raised (host calls
  // at every launch cost time that a 45 us kernel shows)
  static int sms[64] = {};
  static bool smem_set[64][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return -1;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (!smem_set[dev][cap != 0.f]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev][cap != 0.f] = true;
  }
  const long long n_work = (long long)B * H * ((S + WG_BQ - 1) / WG_BQ);
  const int grid = (int)std::min<long long>(n_work, sms[dev]);
  kernel<<<grid, WG_THREADS, T::SMEM, stream>>>(
      qm, km, vm, om, lse, B, S, Sk, H, KH, sc, cl, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q: (B, S, H, hd); k: (B, Sk, KH, hd);
// v: (B, Sk, KH, hdv); o: (B, S, H, hdv); all contiguous.  Sk != S takes
// neither a causal mask nor a window.  (hd, hdv) is
// (64, 64), (128, 128), (256, 256) or MLA's (192, 128), which takes no
// softcap.  lse: null, or (B, H, S) fp32 that receives each row's
// log-sum-exp in natural units, log sum_k exp(s_qk) over the live keys
// (the training forward; serving passes null and does the same work as
// without it).  Returns 0 when the kernel was launched, a CUDA error code
// when the launch was refused, -1 for an unsupported shape or type.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int dtype, int B, int S, int Sk, int H,
                                   int KH, int hd, int hdv, float scale,
                                   int causal, int window, float cap,
                                   void* stream) {
  if (B <= 0 || S <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0 || window < 0)
    return -1;
  if (Sk != S && (causal || window)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define FLASH_FWD_CASE(DQK, DV)                                             \
  if (hd == DQK && hdv == DV)                                               \
    return dtype == 0 ? launch_simt<DQK, DV>(q, k, v, o, l, B, S, Sk, H, KH, \
                                             scale, causal, window, cap, st) \
         : dtype == 1 ? launch_wgmma<DQK, DV>(q, k, v, o, l, B, S, Sk, H,   \
                                              KH, scale, causal, window,    \
                                              cap, st)                      \
                      : -1;
  FLASH_FWD_CASE(64, 64)
  FLASH_FWD_CASE(128, 128)
  FLASH_FWD_CASE(256, 256)
  FLASH_FWD_CASE(192, 128)
#undef FLASH_FWD_CASE
  return -1;
}
