// RWKV6 WKV for Hopper, sm_90a.
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/rwkv6_wkv.py:_wkv_kernel, called through
// kernels/ops.py:wkv6_bshn from models/rwkv.py (every prefill of every
// RWKV layer).
//
// What it computes, per (batch b, head h), with the (N, N) state S:
//   o_t = r_t . S_{t-1} + (r_t . (u (*) k_t)) v_t
//   S_t = diag(exp lw_t) S_{t-1} + k_t v_t^T
// r, k, v (B, S, H, N) in fp32 or bf16; lw (B, S, H, N) fp32 <= 0; u (H, N)
// fp32; s0 (B, H, N, N) fp32.  Out: o (B, S, H, N) in the inputs' dtype,
// rounded once, and s_fin (B, H, N, N) fp32.  All arithmetic is fp32 or
// split TF32 (below).
//
// Design: the chunked form of the Pallas kernel, in chunks of L = 8 steps,
// with its three matrix products on the tensor cores.  With w = exp(lw),
// Pex_t = prod_{s<t} w_s, Psuf_i = prod_{s>i} w_s and P_L = prod_s w_s
// over the chunk (channel-wise, c):
//   o   = (r (*) Pex) . S  +  A . V,      A[t][i] = sum_c r_t k_i
//         prod_{i<s<t} w_s (i < t),  A[t][t] = r_t . (u (*) k_t)
//   S  <- P_L (*) S  +  (k (*) Psuf)^T . V
// Every decay is a product of factors w <= 1, never a quotient or the exp
// of a difference of cumulative sums: nothing overflows at any lw <= 0,
// a strong decay underflows to 0 as the step recurrence does, and the
// rounding is that of a few products (no cancellation in long log-space
// prefix sums).  A step with k = 0 and lw = 0 (ragged padding, or a row
// past S, which the TMA loads as zeros) has w = 1 and k (*) Psuf = 0: the
// state is left exactly as it was (the chunk's product adds +0).
//
// A block owns one (b, h): 2N threads (64 at least) in two roles.  The
// walk warps own a channel a lane; the product warps own 32 value columns
// of S each (16 at N 16), kept transposed in registers as mma.sync
// m16n8k8 accumulator fragments (S^T: 16 columns x N channels a tile).
// Per chunk:
//   * one thread issues the TMA loads of r, k, v and lw for the chunk NST
//     ahead (4-D tensor maps, box (N, 1, L, 1) of the model layout) into a
//     ring of NST stages behind full mbarriers;
//   * a walk lane walks its channel forward (w, r (*) Pex, P_L) and
//     backward (k (*) Psuf, stored as ready mma B fragments), splitting
//     each product into TF32 hi + lo, and forms its terms of the 28
//     strictly lower entries of A (running products) and of the bonus
//     diagonal, summed over the warp's channels by reduce-scatters;
//   * the product warps compute their columns of o^T = S^T (r (*) Pex)^T +
//     V^T A^T and of the state update V^T (k (*) Psuf).  The accumulator
//     fragment of S^T is the A operand of the read-out with its k index
//     permuted (the B fragment uses the same permutation), and one B
//     fragment serves both m16 tiles of a warp.
// The loop is pipelined by one chunk: the walk warps form chunk c + 1
// while the product warps use chunk c, each chunk in one of two buffers,
// with one block barrier a chunk.
//
// Precision: one TF32 rounding of an fp32 operand (2^-11) would miss the
// 1e-5 tolerance, so each fp32 operand is split hi + lo and the products
// are lo.hi + hi.lo + hi.hi (3xTF32; the state's read-out splits by
// truncation, 2^-20); a bf16 operand (V in the bf16 path) is exact in TF32
// and takes two.  The chunk's state update is summed in a fresh
// accumulator and added with one fp32 fmaf, S = S P_L + upd, so the tensor
// cores' truncating accumulation never touches the running state.
//
// Bound on the card: the bytes (r, k, v, o in the inputs' dtype, lw in
// fp32, s0 and s_fin) read and written once, 419 MB at B 8, S 1024, H 64,
// N 64 in bf16, 0.125 ms at 3.35 TB/s (H100 SXM).  The chunked form's
// products, 4 N^2 + 2 L N operations a step at the TF32 rate (495
// TFLOP/s), and its elementwise work, about 2 N^2 / L + (L + 9) N at the
// fp32 rate (67 TFLOP/s), stay under the bytes (chip_smoke.py:wkv_work).
// The kernel issues the read-out three times and the update twice (split
// TF32), and its walks and products overlap only in part: at the serving
// shape it runs at about 2.4x the bytes' time, held by instruction issue
// and latency.
//
// Training passes a checkpoint buffer: the product warps then also write
// the state before every segment of seg steps (a multiple of L), which
// the backward (csrc/rwkv6_wkv_bwd.cu) rebuilds its steps from.  Serving
// passes none and the kernel writes what it always did.
//
// cuTensorMapEncodeTiled comes from the driver through the runtime's
// cudaGetDriverEntryPoint(ByVersion), so the library links no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 8;      // steps per chunk (one k8 step of the products)
constexpr int NST = 4;    // TMA ring stages
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
// One box (N channels, 1 head, L steps, 1 batch row) of a 4-D tensor map
// into shared memory; steps past S arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head, int step,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(head),
      "r"(step), "r"(batch), "r"(bar)
      : "memory");
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

// d += A (16 x 8, row) . B (8 x 8, col), TF32 in, fp32 accumulate.
// A: a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4);
// B: b0 (q, g), b1 (q + 4, g); D: (g, 2q), (g, 2q + 1), (g + 8, 2q),
// (g + 8, 2q + 1); g = lane / 4, q = lane % 4.
// Not volatile: the compiler may move a product among the others' loads
// and arithmetic (it has no effect besides its outputs).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same split with hi truncated and lo left for the tensor core to
// truncate: two instructions, error below 2^-20 relative.  Used for the
// state's read-out only, whose error is not carried to the next chunk.
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d = A . B with C = 0 (the first product of a fresh accumulator)
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
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

// Sums a[0 .. M) of every lane over the warp; lane l ends with the sum of
// a[l % M] (M a power of two <= 32).  M - 1 + 5 - log2 M shuffles.
template <int M>
__device__ __forceinline__ float reduce_scatter(float (&a)[M], int lane) {
  halve<M / 2, M>(a, lane);
#pragma unroll
  for (int off = M; off < 32; off <<= 1)
    a[0] += __shfl_xor_sync(0xffffffffu, a[0], off);
  return a[0];
}

constexpr int KS = 32 * 4 + 8;            // words a kd fragment tile (+pad)

// Shared memory of one block, in bytes from a 128-byte aligned base.
template <typename TI, int N>
struct Smem {
  static constexpr int NWR = N < 32 ? 1 : N / 32;      // walk warps
  static constexpr int IN = L * N * (int)sizeof(TI);   // r, k or v tile
  static constexpr int LW = L * N * 4;
  static constexpr int STAGE = 3 * IN + LW;
  static constexpr int PAD = N + 8;   // conflict-free fragment reads
  // what the walks of a chunk leave for its products, two chunks' worth
  static constexpr int RD = 0;                          // rd hi, lo [L][PAD]
  static constexpr int KD = RD + 2 * L * PAD * 4;       // kd [N/8][KS]
  static constexpr int PL = KD + N / 8 * KS * 4;        // P_L [N]
  static constexpr int AP = PL + N * 4;                 // A pairs [NWR][32]
  static constexpr int AD = AP + NWR * 32 * 4;          // A diagonal [NWR][L]
  static constexpr int ZERO = AD + NWR * L * 4;         // 0.f, 16 bytes
  static constexpr int OS = ZERO + 16;                  // o [L][N + 4]
  static constexpr int BUF = OS + L * (N + 4) * 4;
  static constexpr int BUFS = NST * STAGE;              // after the ring
  static constexpr int BAR = BUFS + 2 * BUF;            // full[NST]
  static constexpr int BYTES = BAR + 8 * NST + 128;     // + alignment slack
};

// Threads: NWR walk warps (one channel a lane; at N 16 half a warp is
// idle) and NWR product warps (NMT m16 tiles, 16 value columns each), 64
// at least.  At N 64 128 registers: four blocks an SM, so the serving
// grid (512 blocks) is one wave.
template <int N>
__host__ __device__ constexpr int threads() {
  return 2 * N < 64 ? 64 : 2 * N;
}

template <typename TI, int N>
__global__ void __launch_bounds__(threads<N>(), 512 / threads<N>())
wkv6_chunked(const __grid_constant__ CUtensorMap rmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap lwmap,
             const float* __restrict__ u, const float* __restrict__ s0,
             TI* __restrict__ o, float* __restrict__ s_fin,
             float* __restrict__ ckpt, int seg_chunks, int S, int H) {
  static_assert(N % 16 == 0 && N <= 64, "N");
  using SM = Smem<TI, N>;
  constexpr int NWR = SM::NWR;          // walk warps = product warps
  constexpr int NMT = N / 16 / NWR;     // m16 tiles a product warp
  constexpr int NT = threads<N>();
  constexpr int NTILE = N / 8;          // n8 tiles of S^T (channels)
  constexpr bool EXACT_V = sizeof(TI) == 2;  // bf16 V is exact in TF32
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const uint32_t bars = smem_u32(base + SM::BAR);
  auto buf = [&](int ch) { return base + SM::BUFS + (ch & 1) * SM::BUF; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int nch = (S + L - 1) / L;
  const bool walker = warp < NWR;     // then the product warps
  auto stage = [&](int s) { return base + s * SM::STAGE; };

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < NST && s < nch; ++s) {
      const uint32_t dst = smem_u32(stage(s)), bar = bars + 8 * s;
      mbar_expect_tx(bar, SM::STAGE);
      tma_load(dst, &rmap, bar, h, s * L, b);
      tma_load(dst + SM::IN, &kmap, bar, h, s * L, b);
      tma_load(dst + 2 * SM::IN, &vmap, bar, h, s * L, b);
      tma_load(dst + 3 * SM::IN, &lwmap, bar, h, s * L, b);
    }
  }

  // a walk warp's lane owns channel c
  const int c = lane + 32 * warp;
  const bool cv = N >= 32 || c < N;   // lanes past N at N 16 idle
  const float uc = walker && cv ? u[h * N + c] : 0.f;

  // S^T fragments of a product warp's columns j0 + 16 mt + {g, g + 8},
  // channels c = 8 nt + 2q + {0, 1}
  const int j0 = 16 * NMT * (warp - NWR);
  float st[NMT][NTILE][4];
  const float* s0p = s0 + (size_t)bh * N * N;
  if (!walker) {
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTILE; ++nt) {
        const int cc = 8 * nt + 2 * q, jj = j0 + 16 * mt + g;
        st[mt][nt][0] = s0p[(size_t)cc * N + jj];
        st[mt][nt][1] = s0p[(size_t)(cc + 1) * N + jj];
        st[mt][nt][2] = s0p[(size_t)cc * N + jj + 8];
        st[mt][nt][3] = s0p[(size_t)(cc + 1) * N + jj + 8];
      }
  }
  const size_t step = (size_t)H * N;
  TI* ob = o + (size_t)b * S * step + (size_t)h * N;
  // where a product lane finds A[g][i], i = q and q + 4, in a chunk's
  // buffer (float index, and the stride between the walk warps'
  // partials): a pair, the diagonal, or the zero above it
  auto a_where = [&](int t, int i, int& off, int& stride) {
    if (i < t) {
      off = SM::AP / 4 + t * (t - 1) / 2 + i;
      stride = 32;
    } else if (i == t) {
      off = SM::AD / 4 + t;
      stride = L;
    } else {
      off = SM::ZERO / 4;
      stride = 0;
    }
  };
  int a_off0, a_step0, a_off1, a_step1;
  a_where(g, q, a_off0, a_step0);
  a_where(g, q + 4, a_off1, a_step1);
  if (tid == 0)
    for (int bb = 0; bb < 2; ++bb)
      *reinterpret_cast<float*>(base + SM::BUFS + bb * SM::BUF + SM::ZERO) =
          0.f;
  __syncthreads();            // barriers initialised

  // -- a walk warp, chunk ch: the walks of channel c and its part of A ----
  auto walks = [&](int ch) {
    const int sl = ch % NST;
    mbar_wait(bars + 8 * sl, (ch / NST) & 1);
    const TI* rs = reinterpret_cast<const TI*>(stage(sl));
    const TI* ks = rs + L * N;
    const float* lws = reinterpret_cast<const float*>(ks + 2 * L * N);
    unsigned char* bb = buf(ch);
    float w[L], rr[L], kk[L];
#pragma unroll
    for (int t = 0; t < L; ++t) {
      w[t] = exp2f(LOG2E * (cv ? lws[t * N + c] : 0.f));
      rr[t] = cv ? to_f(rs[t * N + c]) : 0.f;
      kk[t] = cv ? to_f(ks[t * N + c]) : 0.f;
    }
    // forward: r (*) prod_{s<t} w_s, then P_L
    uint32_t* rd = reinterpret_cast<uint32_t*>(bb + SM::RD);
    float p = 1.f;
#pragma unroll
    for (int t = 0; t < L; ++t) {
      uint32_t hi, lo;
      split(rr[t] * p, hi, lo);
      if (cv) {
        rd[t * SM::PAD + c] = hi;
        rd[(L + t) * SM::PAD + c] = lo;
      }
      p *= w[t];
    }
    if (cv) reinterpret_cast<float*>(bb + SM::PL)[c] = p;
    // backward: k (*) prod_{s>t} w_s as mma B fragments: lane (g', q') of
    // tile nt holds k-steps q' and q' + 4 of channel 8 nt + g', hi then lo
    {
      uint32_t* kd = reinterpret_cast<uint32_t*>(bb + SM::KD);
      uint32_t hi[L], lo[L];
      p = 1.f;
#pragma unroll
      for (int t = L - 1; t >= 0; --t) {
        split(kk[t] * p, hi[t], lo[t]);
        p *= w[t];
      }
      if (cv) {
#pragma unroll
        for (int qq = 0; qq < 4; ++qq)
          *reinterpret_cast<uint4*>(
              &kd[(c >> 3) * KS + ((c & 7) * 4 + qq) * 4]) =
              make_uint4(hi[qq], hi[qq + 4], lo[qq], lo[qq + 4]);
      }
    }
    // A[t][i], i < t: r_t k_i prod_{i<s<t} w_s as a running product from
    // i = t - 1 down, pair (t, i) at t (t - 1) / 2 + i (28 of 32 slots);
    // the bonus r_t . (u (*) k_t) on the diagonal: 4 in the free slots,
    // 4 in a second array
    float a[32], d[4];
#pragma unroll
    for (int t = 1; t < L; ++t) {
      float x = rr[t];
#pragma unroll
      for (int i = t - 1; i >= 0; --i) {
        a[t * (t - 1) / 2 + i] = x * kk[i];
        x *= w[i];
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      a[28 + t] = rr[t] * uc * kk[t];
      d[t] = rr[4 + t] * uc * kk[4 + t];
    }
    const float pa = reduce_scatter<32>(a, lane);
    const float pd = reduce_scatter<4>(d, lane);
    float* ap = reinterpret_cast<float*>(bb + SM::AP);
    float* ad = reinterpret_cast<float*>(bb + SM::AD);
    if (lane < 28) ap[warp * 32 + lane] = pa;
    else ad[warp * L + lane - 28] = pa;
    if (lane < 4) ad[warp * L + 4 + lane] = pd;
  };

  // the state before chunk ch, written by the product warps at the start
  // of every segment of seg_chunks chunks when a checkpoint buffer is
  // passed (training; serving passes none)
  auto checkpoint = [&](int ch) {
    const int nseg = (nch + seg_chunks - 1) / seg_chunks;
    float* cp = ckpt + ((size_t)bh * nseg + ch / seg_chunks) * N * N;
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTILE; ++nt) {
        const int cc = 8 * nt + 2 * q, jj = j0 + 16 * mt + g;
        cp[(size_t)cc * N + jj] = st[mt][nt][0];
        cp[(size_t)(cc + 1) * N + jj] = st[mt][nt][1];
        cp[(size_t)cc * N + jj + 8] = st[mt][nt][2];
        cp[(size_t)(cc + 1) * N + jj + 8] = st[mt][nt][3];
      }
  };

  // -- a product warp, chunk ch: o^T = S^T rd^T + V^T A^T, and the state --
  auto products = [&](int ch) {
    if (ckpt != nullptr && ch % seg_chunks == 0) checkpoint(ch);
    const TI* vs = reinterpret_cast<const TI*>(stage(ch % NST)) + 2 * L * N;
    const unsigned char* bb = buf(ch);
    const uint32_t* rd = reinterpret_cast<const uint32_t*>(bb + SM::RD);
    const uint32_t* kd = reinterpret_cast<const uint32_t*>(bb + SM::KD);
    const float* pl = reinterpret_cast<const float*>(bb + SM::PL);
    const float* abuf = reinterpret_cast<const float*>(bb);
    float* os = reinterpret_cast<float*>(buf(ch) + SM::OS);
    uint32_t vt[NMT][4], vt_lo[NMT][4];
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) {
      const int jj = j0 + 16 * mt + g;
      const float vf[4] = {to_f(vs[q * N + jj]), to_f(vs[q * N + jj + 8]),
                           to_f(vs[(q + 4) * N + jj]),
                           to_f(vs[(q + 4) * N + jj + 8])};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (EXACT_V) {
          vt[mt][e] = __float_as_uint(vf[e]);
          vt_lo[mt][e] = 0u;
        } else {
          split(vf[e], vt[mt][e], vt_lo[mt][e]);
        }
      }
    }
    // tile nt's read-out uses the state before its update, in the same
    // iteration, so the chains interleave; the B fragments serve every m16
    // tile
    float oacc[NMT][4];
#pragma unroll
    for (int nt = 0; nt < NTILE; ++nt) {
      const uint2 bh2 = *reinterpret_cast<const uint2*>(
          &rd[g * SM::PAD + 8 * nt + 2 * q]);
      const uint2 bl2 = *reinterpret_cast<const uint2*>(
          &rd[(L + g) * SM::PAD + 8 * nt + 2 * q]);
      const uint4 kf = *reinterpret_cast<const uint4*>(&kd[nt * KS + lane * 4]);
      const float2 d = *reinterpret_cast<const float2*>(&pl[8 * nt + 2 * q]);
#pragma unroll
      for (int mt = 0; mt < NMT; ++mt) {
        // k index q <-> channel 8nt + 2q, q + 4 <-> 8nt + 2q + 1
        uint32_t ah[4], al[4];
        split_trunc(st[mt][nt][0], ah[0], al[0]);
        split_trunc(st[mt][nt][2], ah[1], al[1]);
        split_trunc(st[mt][nt][1], ah[2], al[2]);
        split_trunc(st[mt][nt][3], ah[3], al[3]);
        float (&acc)[4] = oacc[mt];
        if (nt == 0)
          mma0(acc, al, bh2.x, bh2.y);
        else
          mma(acc, al, bh2.x, bh2.y);
        mma(acc, ah, bl2.x, bl2.y);
        mma(acc, ah, bh2.x, bh2.y);

        float upd[4];
        if (EXACT_V) {
          mma0(upd, vt[mt], kf.z, kf.w);
        } else {
          mma0(upd, vt_lo[mt], kf.x, kf.y);
          mma(upd, vt[mt], kf.z, kf.w);
        }
        mma(upd, vt[mt], kf.x, kf.y);
        st[mt][nt][0] = fmaf(st[mt][nt][0], d.x, upd[0]);
        st[mt][nt][1] = fmaf(st[mt][nt][1], d.y, upd[1]);
        st[mt][nt][2] = fmaf(st[mt][nt][2], d.x, upd[2]);
        st[mt][nt][3] = fmaf(st[mt][nt][3], d.y, upd[3]);
      }
    }
    // A[g][q] and A[g][q + 4], summed over the walk warps and split
    float x0 = 0.f, x1 = 0.f;
#pragma unroll
    for (int r = 0; r < NWR; ++r) {
      x0 += abuf[a_off0 + r * a_step0];
      x1 += abuf[a_off1 + r * a_step1];
    }
    uint32_t bh0, bh1, bl0, bl1;
    split(x0, bh0, bl0);
    split(x1, bh1, bl1);
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) {
      float (&acc)[4] = oacc[mt];
      if (!EXACT_V) mma(acc, vt_lo[mt], bh0, bh1);
      mma(acc, vt[mt], bl0, bl1);
      mma(acc, vt[mt], bh0, bh1);
      const int jj = j0 + 16 * mt + g;
      os[(2 * q) * (N + 4) + jj] = acc[0];
      os[(2 * q + 1) * (N + 4) + jj] = acc[1];
      os[(2 * q) * (N + 4) + jj + 8] = acc[2];
      os[(2 * q + 1) * (N + 4) + jj + 8] = acc[3];
    }
  };

  // Software pipelined by one chunk: the walk warps form chunk ch + 1 while
  // the product warps use chunk ch (each has its own buffers), one barrier
  // a chunk.
  if (walker) walks(0);
  __syncthreads();
  for (int ch = 0; ch < nch; ++ch) {
    if (walker) {
      if (ch + 1 < nch) walks(ch + 1);
    } else {
      products(ch);
    }
    __syncthreads();   // stage ch, chunk ch's buffers and ch + 1's walks

    if (tid == 0 && ch + NST < nch) {
      const int sl = ch % NST;
      const uint32_t dst = smem_u32(stage(sl)), bar = bars + 8 * sl;
      const int t0 = (ch + NST) * L;
      mbar_expect_tx(bar, SM::STAGE);
      tma_load(dst, &rmap, bar, h, t0, b);
      tma_load(dst + SM::IN, &kmap, bar, h, t0, b);
      tma_load(dst + 2 * SM::IN, &vmap, bar, h, t0, b);
      tma_load(dst + 3 * SM::IN, &lwmap, bar, h, t0, b);
    }
    // o rows of chunk ch, 4 channels a thread at a time (its buffer is
    // next written by chunk ch + 2's products, after the next barrier)
    const float* os = reinterpret_cast<const float*>(buf(ch) + SM::OS);
    const int t0 = ch * L;
    for (int idx = tid; idx < L * N / 4; idx += NT) {
      const int t = idx / (N / 4), cc = 4 * (idx - t * (N / 4));
      if (t0 + t < S) {
        const float4 x = *reinterpret_cast<const float4*>(
            &os[t * (N + 4) + cc]);
        TI* dst = ob + (size_t)(t0 + t) * step + cc;
        if constexpr (EXACT_V) {
          const __nv_bfloat162 lo2 = __floats2bfloat162_rn(x.x, x.y);
          const __nv_bfloat162 hi2 = __floats2bfloat162_rn(x.z, x.w);
          uint2 pk;
          pk.x = *reinterpret_cast<const uint32_t*>(&lo2);
          pk.y = *reinterpret_cast<const uint32_t*>(&hi2);
          *reinterpret_cast<uint2*>(dst) = pk;
        } else {
          *reinterpret_cast<float4*>(dst) = x;
        }
      }
    }
  }

  if (!walker) {
    float* sf = s_fin + (size_t)bh * N * N;
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTILE; ++nt) {
        const int cc = 8 * nt + 2 * q, jj = j0 + 16 * mt + g;
        sf[(size_t)cc * N + jj] = st[mt][nt][0];
        sf[(size_t)(cc + 1) * N + jj] = st[mt][nt][1];
        sf[(size_t)cc * N + jj + 8] = st[mt][nt][2];
        sf[(size_t)(cc + 1) * N + jj + 8] = st[mt][nt][3];
      }
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

// A (B, S, H, N) tensor as a 4-D map, innermost first: (N, H, S, B), boxes
// of (N, 1, L, 1) without swizzle, so a stage tile is [L][N] row-major.
// Steps past S load as zeros.
bool tensor_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr,
                CUtensorMapDataType type, int elt, int B, int S, int H,
                int N) {
  const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)N * elt,
                                 (cuuint64_t)H * N * elt,
                                 (cuuint64_t)S * H * N * elt};
  const cuuint32_t box[4] = {(cuuint32_t)N, 1, (cuuint32_t)L, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, type, 4, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TI, int N>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* s0, void* o, void* s_fin, void* ckpt,
           int seg, int B, int S, int H, cudaStream_t stream) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType ty = sizeof(TI) == 2
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap rm, km, vm, lwm;
  if (!tensor_map(enc, &rm, r, ty, sizeof(TI), B, S, H, N) ||
      !tensor_map(enc, &km, k, ty, sizeof(TI), B, S, H, N) ||
      !tensor_map(enc, &vm, v, ty, sizeof(TI), B, S, H, N) ||
      !tensor_map(enc, &lwm, lw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, S, H,
                  N))
    return (int)cudaErrorInvalidValue;     // e.g. a base not 16-byte aligned
  constexpr int smem = Smem<TI, N>::BYTES;
  // once per instantiation and device (a host call at every launch costs
  // time that a short kernel shows)
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return -1;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(wkv6_chunked<TI, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  wkv6_chunked<TI, N><<<B * H, threads<N>(), smem, stream>>>(
      rm, km, vm, lwm, static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<TI*>(o),
      static_cast<float*>(s_fin), static_cast<float*>(ckpt),
      ckpt == nullptr ? 1 : seg / L, S, H);
  return (int)cudaGetLastError();
}

template <typename TI>
int dispatch_n(int N, const void* r, const void* k, const void* v,
               const void* lw, const void* u, const void* s0, void* o,
               void* s_fin, void* ckpt, int seg, int B, int S, int H,
               cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<TI, 16>(r, k, v, lw, u, s0, o, s_fin, ckpt, seg, B, S, H,
                            stream);
    case 32:
      return launch<TI, 32>(r, k, v, lw, u, s0, o, s_fin, ckpt, seg, B, S, H,
                            stream);
    case 64:
      return launch<TI, 64>(r, k, v, lw, u, s0, o, s_fin, ckpt, seg, B, S, H,
                            stream);
    default:
      return -1;
  }
}

}  // namespace

// dt: 0 = fp32, 1 = bf16 (r, k, v and o).  All operands contiguous, the
// inputs 16-byte aligned (TMA).  ckpt: null (serving), or a (B, H,
// ceil(S / seg), N, N) fp32 buffer that receives the state before every
// seg-th step (training; seg a multiple of the chunk, 8).  Returns 0 when
// launched, a CUDA error code when the launch or a tensor map was refused,
// -1 for an unsupported shape or type.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* lw, const void* u, const void* s0,
                        void* o, void* s_fin, void* ckpt, int dt, int B,
                        int S, int H, int N, int seg, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H > 0x7fffffffLL)
    return -1;
  if (ckpt != nullptr && (seg <= 0 || seg % L != 0)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt == 0)
    return dispatch_n<float>(N, r, k, v, lw, u, s0, o, s_fin, ckpt, seg, B,
                             S, H, st);
  if (dt == 1)
    return dispatch_n<__nv_bfloat16>(N, r, k, v, lw, u, s0, o, s_fin, ckpt,
                                     seg, B, S, H, st);
  return -1;
}
