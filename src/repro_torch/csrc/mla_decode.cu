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
// entry is in [0, P); pos_q < 0 gives a zero row; a -1 entry, or one past
// the pool, is never dereferenced.
//
// Design: one launch.  The TPU grid walked (batch, page) with one program
// holding all H heads and the page axis sequential.  Here the key axis of
// a row is cut into tiles of TK = 32 keys that never cross a page (a page
// holds ceil(ps / 32) tiles), and the tiles into n_split ranges of `tpr`
// tiles.  A work item is (range, head tile, row), one block each; the
// n_split ranges of a (row, head tile) form one thread-block cluster, and
// their partial softmax states are merged through distributed shared
// memory in the same launch, so no partial goes to device memory.  The
// decomposition and the shared-memory layout come from the wrapper's plan
// (kernels/paged_attention.py:mla_decode_plan), computed from the shapes
// and the card: the cluster size is the one with the shortest critical
// path, waves of clusters times tiles a range, where the card's capacity
// for clusters comes from the runtime (mla_decode_cluster_slots below: an
// H100 holds 15 clusters of 8 such blocks at once, not 16, for a cluster
// must fit one GPC).  A block reads its own table row and position, and a
// range that starts past pos_q does no key work, so the host reads
// neither.
//
// * bf16 q over bf16 pools (the serving path): a head tile is 64 heads,
//   one wgmma row band (a partial tile masks its dead rows).  Three
//   warpgroups.  The producer (one thread, 40 registers after setmaxnreg)
//   copies each live tile of ckv and krope with TMA (3-D tensor maps
//   (cols, ps, P), boxes of 64 columns x 32 keys with the 128-byte
//   swizzle; keys past the page arrive as zeros) into a ring of `stages`
//   36 KB stages behind full/empty mbarriers.  Both consumers first copy
//   the item's 64 query rows (72 KB) into shared memory in the same
//   swizzled layout (cp.async, under the table reads and the first TMA).  Consumer 0 computes S (64 x 32) = Q K^T over the 576
//   dims as 36 wgmma m64n32k16 (bf16 products, fp32 sums; the scale goes
//   onto the fp32 score), runs the online softmax in log2 units, splits P
//   into bf16 hi + lo (P - hi rounded again: 2^-18 relative, near fp32)
//   and hands hi, lo and the rescale factors to consumer 1 through a
//   double-buffered shared-memory slot (mbarriers).  Each consumer holds a
//   64 x 256 fp32 accumulator (128 registers) for half of the 512 latent
//   dims and adds hi V + lo V with wgmma (P from registers, V the
//   MN-major ckv tile).  Consumer 0 issues tile i's S before tile i-1's
//   P V and runs the softmax while that is in flight; every product is
//   waited for in the iteration that issued it, and roles, positions and
//   tile sizes are broadcast from lane 0, so that ptxas sees every branch
//   around a wgmma as uniform (else it serialises all of them).  Dead key
//   rows of a tile (past pos_q) are zeroed before P V, so stale pool
//   contents never reach the sum (p = 0 times a non-finite value would).
// * fp32 q (fp32 or bf16 pools; parity and exactness runs): the same walk
//   and cluster merge on the CUDA cores, a head tile of 16 heads, 256
//   threads, each 32-key tile of [ckv ‖ krope] in shared memory (widened
//   to fp32 on use), scores 2 heads x 4 keys a thread over a quarter of
//   the dims, P V in fp32.
//
// Merge: every block stages its unnormalised accumulator (64 or 16 rows x
// 512 fp32) and its rows' (m, l) in its own shared memory; after a cluster
// barrier, block r of the cluster merges columns [r w, (r + 1) w) of every
// row from the live blocks of the cluster (distributed shared memory
// loads), w ~ 512 / n_split, and writes them; a second cluster barrier
// keeps every block alive until its peers have read it.  A row whose live
// keys fall in one range is written by that block alone, straight from
// its registers.  (Pushing the partials into the merging blocks with
// remote stores instead was several times slower: distributed shared
// memory is bound by its transactions, and the fragments give 8 bytes a
// store.)
//
// Bound on the card: the live latent keys read once, (distinct live keys)
// x (lora + rd) x sizeof(element), at 3.35 TB/s, against sum_rows (live
// keys) x H x (576 + 512) x 2 operations at 989 TFLOP/s (bf16); at
// deepseek-v2's serving shape (B 8, H 128, 4,196 distinct live keys) the
// bytes bound, at 2.1 us.  What holds it back (tools/mla_knockout.py
// times the kernel with each phase removed): per tile, the S product, whose
// m64n32 steps each read 3 KB of shared memory for 16 cycles of tensor
// work (shared-memory bandwidth, not the tensor cores, bounds it), and
// P V, twice over for hi and lo; per block, the launch of a cluster, the
// query copy and the ring's fill; per cluster, the merge's distributed
// shared-memory loads.  At the serving shape a block walks at most 6
// tiles, and these latencies, not bytes, set the time.
//
// cuTensorMapEncodeTiled comes from the driver through the runtime's
// cudaGetDriverEntryPoint(ByVersion), so the library links no -lcuda.  The
// pools' tensor maps are cached per (device, pointer, pages, page size):
// the engine's pools live as long as the engine, so a decode step encodes
// none.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TK = 32;            // keys a tile
constexpr int LORA = 512;         // latent width (MLA_DIMS)
constexpr int RD = 64;            // rope width
constexpr int DQ = LORA + RD;     // score width
constexpr int MAX_CLUSTER = 8;    // ranges a (row, head tile): one cluster
constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;

// wgmma route
constexpr int WG_HEADS = 64;      // heads a block: one wgmma row band
constexpr int WG_THREADS = 384;   // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;   // (40 + 2 x 232) x 128 <= 65,536
constexpr uint32_t Q_BLK = WG_HEADS * 128;     // one 64-column block of Q
constexpr uint32_t K_BLK = TK * 128;           // one 64-column block of a tile
constexpr uint32_t STAGE_BYTES = TK * DQ * 2;  // ckv and krope of a tile
// a P hand-over slot: hi and lo fragments [2][TK / 16][4][128] u32, then
// the rescale factors [128] float2
constexpr uint32_t P_FRAGS = 2 * (TK / 16) * 4 * 128 * 4;
constexpr uint32_t P_SLOT = P_FRAGS + 128 * 8;

// SIMT route
constexpr int SIMT_HEADS = 16;    // heads a block (2 per warp)
constexpr int SIMT_THREADS = 256;

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The tiles of one (row, range): tile tau is keys first_key(tau) ..
// first_key(tau) + keys(tau) - 1 of page tau / ntp, live if its table
// entry is in the pool.
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
  __device__ __forceinline__ int slot(int tau) const {   // within the page
    return (tau % ntp) * TK;
  }
  __device__ __forceinline__ int keys(int tau) const {
    const int j = tau % ntp;
    return min(min(TK, ps - j * TK), pos - ((tau / ntp) * ps + j * TK) + 1);
  }
};

// The last live tile of a row at position pos >= 0 (the same for every
// block of a cluster).
__device__ __forceinline__ int last_tile(int pos, int ps, int pps, int ntp) {
  const int page = pos / ps;
  return page >= pps ? pps * ntp - 1 : page * ntp + (pos - page * ps) / TK;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- clusters and distributed shared memory -------------------------------
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}
// The address of this block's shared-memory location ``addr`` in the
// shared memory of block ``rank`` of the cluster.
__device__ __forceinline__ uint32_t map_peer(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
// A value that every lane of the warp holds, as lane 0's: the compiler
// then knows a branch on it does not diverge (a wgmma under a branch it
// cannot prove uniform is serialised).
__device__ __forceinline__ int uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
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

__device__ __forceinline__ float4 ld_peer4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The merge of a (row, head tile)'s ranges.  Every block stages its
// partial state in its own shared memory: the unnormalised accumulator
// [ROWS][ACC_STRIDE] fp32 and its rows' (m, l).  After a cluster barrier,
// block r reads columns [r cols, r cols + cols) of every row from the
// n_live live blocks (distributed shared memory, 16 bytes a load, the
// loads of all sources for two items issued before any is used), sums
// them with weights 2^(m_p - M) (e^ without LOG2), writes them divided by
// the weighted l, and a second cluster barrier keeps every block alive
// until its peers have read it.  When one range holds every live key
// (n_live 1) its block writes acc / l straight from its registers, and no
// block merges.  (Two other exchanges were slower on the card: the
// partials pushed by remote stores, 8 bytes each, and staged slices sent
// by cp.async.bulk one destination after the other.)
constexpr int ACC_STRIDE = LORA + 4;

// Shared memory of the (m, l) block, in floats: this block's m and l
// [ROWS] each (the SIMT walk keeps its running values there, the bf16
// route hands l over there), the sources' m and l [MAX_CLUSTER][ROWS]
// each, the weights [MAX_CLUSTER][ROWS], 1 / L [ROWS] and (SIMT) the
// rescale factors [ROWS].
template <int ROWS>
struct MlLayout {
  static constexpr int OWN_M = 0, OWN_L = ROWS, M = 2 * ROWS,
                       L = (2 + MAX_CLUSTER) * ROWS,
                       W = (2 + 2 * MAX_CLUSTER) * ROWS,
                       INV = (2 + 3 * MAX_CLUSTER) * ROWS,
                       CORR = (3 + 3 * MAX_CLUSTER) * ROWS;
};

// Block ``rank`` merges its columns.  ``acc_s`` / ``ml_s``: this block's
// staged accumulator and (m, l) block (shared addresses; a peer's are the
// same offsets in its shared memory), ``ml`` the (m, l) block's generic
// pointer.  Called by ``nt`` threads (t = 0 .. nt - 1) that share named
// barrier ``bar``, after the staged states are visible.
template <typename TO, int ROWS, bool LOG2>
__device__ void merge_ranges(uint32_t acc_s, uint32_t ml_s, float* ml,
                             int n_live, int cols, int rank, int t, int nt,
                             int bar, TO* out, int rows_valid) {
  using ML = MlLayout<ROWS>;
  constexpr int Q4 = ROWS / 4;                 // float4s of an (m or l) row
  // every source's m and l, 16 bytes a load
  for (int i = t; i < n_live * 2 * Q4; i += nt) {
    const int p = i / (2 * Q4), k = i - p * 2 * Q4, isl = k / Q4;
    const int j = 4 * (k - isl * Q4);
    const float4 v = ld_peer4(map_peer(
        ml_s + 4 * ((isl ? ML::OWN_L : ML::OWN_M) + j), p));
    *reinterpret_cast<float4*>(ml + (isl ? ML::L : ML::M) + p * ROWS + j) = v;
  }
  named_bar(bar, nt);
  for (int r = t; r < ROWS; r += nt) {
    float M = NEG_INF;
    for (int p = 0; p < n_live; ++p) M = fmaxf(M, ml[ML::M + p * ROWS + r]);
    float L = 0.f;
    for (int p = 0; p < n_live; ++p) {
      // a source with no live key (m = NEG_INF) has weight 0
      const float mp = ml[ML::M + p * ROWS + r];
      const float w =
          mp == NEG_INF ? 0.f : (LOG2 ? ex2(mp - M) : expf(mp - M));
      L = fmaf(ml[ML::L + p * ROWS + r], w, L);
      ml[ML::W + p * ROWS + r] = w;
    }
    ml[ML::INV + r] = 1.f / fmaxf(L, 1e-37f);
  }
  named_bar(bar, nt);
  const int c0 = rank * cols, nch = (min(LORA, c0 + cols) - c0) / 4;
  uint32_t peer[MAX_CLUSTER];
#pragma unroll
  for (int p = 0; p < MAX_CLUSTER; ++p)
    peer[p] = map_peer(acc_s, p < n_live ? p : 0);
  // two items a round, every load of both issued before any is used
  for (int it0 = t; it0 < ROWS * nch; it0 += 2 * nt) {
    int r[2], col[2];
    float4 v[2][MAX_CLUSTER];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int it = it0 + u * nt;
      r[u] = it < ROWS * nch ? it / nch : ROWS;
      col[u] = c0 + 4 * (it - r[u] * nch);
      if (r[u] < rows_valid)
#pragma unroll
        for (int p = 0; p < MAX_CLUSTER; ++p)
          if (p < n_live)
            v[u][p] = ld_peer4(peer[p] + 4 * (r[u] * ACC_STRIDE + col[u]));
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (r[u] >= rows_valid) continue;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int p = 0; p < MAX_CLUSTER; ++p) {
        // a weight-0 source staged no accumulator: its slot is stale
        const float w = p < n_live ? ml[ML::W + p * ROWS + r[u]] : 0.f;
        if (w != 0.f) {
          a.x = fmaf(v[u][p].x, w, a.x);
          a.y = fmaf(v[u][p].y, w, a.y);
          a.z = fmaf(v[u][p].z, w, a.z);
          a.w = fmaf(v[u][p].w, w, a.w);
        }
      }
      const float inv = ml[ML::INV + r[u]];
      store4(out + (size_t)r[u] * LORA + col[u],
             make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma route: bf16 q over bf16 pools
// ---------------------------------------------------------------------------
// One box (64 columns, TK keys, 1 page) of a 3-D tensor map (cols, ps, P)
// into shared memory; keys past the page arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int slot,
                                         int page) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(slot),
      "r"(page), "r"(bar)
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
// stored as blocks of 64 columns (128 bytes a row, the TMA box), 8-row
// groups 1,024 bytes apart (the stride byte offset).  ``lbo`` is the byte
// distance between two column blocks, read only for an MN-major operand
// whose N spans several of them (V).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= A (64 x 16, shared, K-major) . B (16 x 32, shared, K-major);
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
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

// S = Q K^T for the 64 rows and a 32-key tile: 36 k-steps of 16 dims.
// Within a 128-byte swizzle atom a k-step advances the start address by 32
// bytes; every 4 k-steps move to the next 64-column block (8 of ckv, then
// krope's).  Each m64n32 product reads 3 KB of shared memory for 16
// cycles of tensor work: shared-memory bandwidth, not the tensor cores,
// bounds it.
__device__ __forceinline__ void qk_product(float (&s)[16], uint32_t q_s,
                                           uint32_t kb) {
#pragma unroll
  for (int ks = 0; ks < DQ / 16; ++ks) {
    const uint64_t da = sw128_desc(q_s + (ks >> 2) * Q_BLK + (ks & 3) * 32,
                                   16);
    const uint64_t db = sw128_desc(kb + (ks >> 2) * K_BLK + (ks & 3) * 32,
                                   16);
    wgmma_ss_n32(s, da, db, ks > 0);
  }
}

// acc *= the rescale factor of its row (pairs of columns alternate
// between the thread's two rows), skipped by a warp whose rows' maxima
// did not move.
__device__ __forceinline__ void rescale(float (&acc)[128],
                                        const float (&corr)[2]) {
  if (!__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] *= corr[(i >> 1) & 1];
}

// acc += (hi + lo) V over consumer c's 256 latent columns (the tile's
// column blocks 4c .. 4c + 3, K_BLK apart): per 16-key k-step two n128
// products for hi and two for lo.
__device__ __forceinline__ void pv_product(float (&acc)[128],
                                           const uint32_t (&ph)[TK / 16][4],
                                           const uint32_t (&pl)[TK / 16][4],
                                           uint32_t kb, int c) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    const uint32_t a = kb + 4 * c * K_BLK + kk * 16 * 128;
    wgmma_rs_n128<0>(acc, ph[kk], sw128_desc(a, K_BLK));
    wgmma_rs_n128<64>(acc, ph[kk], sw128_desc(a + 2 * K_BLK, K_BLK));
    wgmma_rs_n128<0>(acc, pl[kk], sw128_desc(a, K_BLK));
    wgmma_rs_n128<64>(acc, pl[kk], sw128_desc(a + 2 * K_BLK, K_BLK));
  }
}

// Zeroes key rows nv .. TK - 1 of column blocks 4c .. 4c + 3 of a tile
// (whole 128-byte rows, so the swizzle does not matter), then makes the
// writes visible to wgmma and waits for the consumer's other warps.
__device__ __forceinline__ void zero_dead_rows(uint32_t kb, int c, int nv,
                                               int t) {
  for (int idx = t; idx < (TK - nv) * 32; idx += 128) {
    const int row = nv + (idx >> 5), blk = 4 * c + ((idx >> 3) & 3);
    const uint32_t addr = kb + blk * K_BLK + row * 128 + (idx & 7) * 16;
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                 "r"(0), "r"(0), "r"(0), "r"(0)
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_bar(2 + c, 128);
}

// The online softmax of one score tile in log2 units, in place: s becomes
// p = 2^(s sc - m), m the running row max (sc = scale log2 e on the fp32
// score); keys at or past ``nv`` are dead (p = 0).  ``corr`` is what the
// running sums and the accumulator must be multiplied by, ``rs`` this
// thread's share of the tile's row sums.  Every head sees the same keys
// and a tile holds at least one live key, so m is finite after the first.
__device__ __forceinline__ void online_softmax(float (&s)[16], float (&m)[2],
                                               float (&rs)[2],
                                               float (&corr)[2], int nv,
                                               float sc, int tq) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
    const float x = col < nv ? s[i] * sc : NEG_INF;
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    rs[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
    const float p = col < nv ? ex2(s[i] - m[r]) : 0.f;
    s[i] = p;
    rs[r] += p;
  }
}

__device__ __forceinline__ uint32_t bf16x2(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The fp32 probabilities as bf16 A fragments of the P V k-steps, hi =
// bf16(p) and lo = bf16(p - hi): the accumulators of key columns 16 kk ..
// 16 kk + 15 are exactly the A fragment of k-step kk.
__device__ __forceinline__ void split_p(const float (&s)[16],
                                        uint32_t (&ph)[TK / 16][4],
                                        uint32_t (&pl)[TK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = s[8 * kk + 2 * j], b = s[8 * kk + 2 * j + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      ph[kk][j] = bf16x2(h);
      pl[kk][j] = bf16x2(__floats2bfloat162_rn(a - hf.x, b - hf.y));
    }
}

// One block: range blockIdx.x (its rank in the cluster of the n_split
// ranges), head tile blockIdx.y, row blockIdx.z.  Shared memory (offsets
// from the plan, from a 1,024-aligned base): Q [9 blocks][64][128 B] at 0,
// the ring at off_ring (``stages`` x 36 KB), the P hand-over slots at
// off_pbuf, the (m, l) block at off_ml, mbarriers at off_bars; after the
// walk the staged partial accumulator [64][ACC_STRIDE] overlays Q and the
// ring.
__global__ void __launch_bounds__(WG_THREADS, 1)
mla_decode_wgmma(const __grid_constant__ CUtensorMap cmap,
                 const __grid_constant__ CUtensorMap rmap,
                 const __nv_bfloat16* __restrict__ q,
                 const int* __restrict__ pt, const int* __restrict__ posq,
                 __nv_bfloat16* __restrict__ o, int H, int ps, int pps,
                 int n_pool, int ntp, int tpr, int stages, int cols,
                 int off_ring, int off_pbuf, int off_ml, int off_bars,
                 float sc) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t q_s = base, ring = base + off_ring, pbuf = base + off_pbuf;
  const uint32_t ml_s = base + off_ml, bars = base + off_bars;
  float* ml = reinterpret_cast<float*>(gbase + off_ml);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (stages + s); };
  auto p_full = [&](int k) { return bars + 8 * (2 * stages + k); };
  auto p_empty = [&](int k) { return bars + 8 * (2 * stages + 2 + k); };

  const int rank = blockIdx.x, n_split = gridDim.x;   // the cluster spans x
  const int h0 = blockIdx.y * WG_HEADS, b = blockIdx.z;
  const int rows_valid = min(WG_HEADS, H - h0);
  __nv_bfloat16* out = o + ((size_t)b * H + h0) * LORA;
  const int pos = uniform(posq[b]);
  if (pos < 0) {                 // an inactive slot: range 0 writes zeros
    if (rank == 0)
      for (int i = threadIdx.x; i < rows_valid * LORA / 4; i += WG_THREADS)
        store4(out + 4 * i, make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }
  const int last = last_tile(pos, ps, pps, ntp);
  const int n_live = min(n_split, last / tpr + 1);
  if (n_live == 1 && rank > 0) return;   // range 0 holds every live key
  const int tau0 = rank * tpr;
  const Walk walk{pt + (size_t)b * pps, ps, ntp, pos, n_pool,
                  min(tau0 + tpr, last + 1)};

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);            // one arrival per consumer warp
    }
    for (int k = 0; k < 2; ++k) {
      mbar_init(p_full(k), 4);           // consumer 0's warps
      mbar_init(p_empty(k), 4);          // consumer 1's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = uniform(threadIdx.x / 128);
  if (wg == 0) {
    // ---- producer: the range's live tiles through the ring ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int n = 0;
      for (int tau = walk.next(tau0); tau < walk.end;
           tau = walk.next(tau + 1), ++n) {
        const int s = n % stages;
        mbar_wait(empty(s), ((n / stages) & 1) ^ 1);   // round 0 passes
        mbar_expect_tx(full(s), STAGE_BYTES);
        const uint32_t dst = ring + s * STAGE_BYTES;
        const int page = walk.entry(tau), slot = walk.slot(tau);
#pragma unroll
        for (int c = 0; c < LORA / 64; ++c)
          tma_load(dst + c * K_BLK, &cmap, full(s), 64 * c, slot, page);
        tma_load(dst + (LORA / 64) * K_BLK, &rmap, full(s), 0, slot, page);
      }
    }
    if (n_live > 1) {            // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = wg - 1;                          // consumer 0 or 1
  const int t = threadIdx.x - 128 * wg;          // thread in the warpgroup
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  if (rank < n_live) {
    // the item's 64 query rows in the swizzled layout of the TMA box, 18
    // 16-byte cp.async copies a thread (rows past H are zero-filled),
    // issued before the walk reads the table; waited for before S
    constexpr int CH = DQ / 8;                   // chunks a row
#pragma unroll
    for (int i = 0; i < WG_HEADS * CH / 256; ++i) {
      const int idx = t + 128 * c + 256 * i, r = idx / CH, ch = idx % CH;
      const bool live = h0 + r < H;
      const __nv_bfloat16* src =
          live ? q + ((size_t)b * H + h0 + r) * DQ + ch * 8 : q;
      const uint32_t dst = q_s + (ch >> 3) * Q_BLK + r * 128 +
                           (((ch & 7) ^ (r & 7)) << 4);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst),
                   "l"(src), "r"(live ? 16 : 0)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const int first = uniform(walk.next(tau0));
  const bool any = first < walk.end;
  if (rank < n_live) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_bar(1, 256);
  }

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t ph[TK / 16][4], pl[TK / 16][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  if (c == 0 && any) {
    // S of tile n is issued with P V of tile n - 1, and the softmax of S
    // runs while P V is in flight; every wait is in the iteration that
    // issued the product
    float s[16], rs[2], corr[2];
    // P and the rescale factors to consumer 1 through slot n % 2
    auto hand_over = [&](int n, float cf0, float cf1) {
      const int k = n & 1;
      mbar_wait(p_empty(k), ((n >> 1) & 1) ^ 1);
      const uint32_t slot = pbuf + k * P_SLOT;
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t a = slot + (((kk * 4 + j) * 128 + t) << 2);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(ph[kk][j])
                       : "memory");
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a + P_FRAGS / 2),
                       "r"(pl[kk][j])
                       : "memory");
        }
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                       slot + P_FRAGS + 8 * t),
                   "f"(cf0), "f"(cf1)
                   : "memory");
      release(p_full(k));
    };
    int tau = first, nv = uniform(walk.keys(tau));
    mbar_wait(full(0), 0);
    wgmma_fence();
    qk_product(s, q_s, ring);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    online_softmax(s, m, rs, corr, nv, sc, tq);   // corr 0: acc is 0
    l[0] = rs[0];
    l[1] = rs[1];
    if (nv < TK) zero_dead_rows(ring, 0, nv, t);
    split_p(s, ph, pl);
    hand_over(0, corr[0], corr[1]);
    int prev = 0, n = 1;
    for (tau = uniform(walk.next(tau + 1)); tau < walk.end;
         tau = uniform(walk.next(tau + 1)), ++n) {
      const int st = n % stages;
      nv = uniform(walk.keys(tau));
      const uint32_t kb = ring + st * STAGE_BYTES;
      mbar_wait(full(st), (n / stages) & 1);
      wgmma_fence();
      qk_product(s, q_s, kb);
      wgmma_commit();
      pv_product(acc, ph, pl, ring + prev * STAGE_BYTES, 0);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(s);
      online_softmax(s, m, rs, corr, nv, sc, tq);
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(ph);
      reg_fence(pl);
      release(empty(prev));
      rescale(acc, corr);
      l[0] = l[0] * corr[0] + rs[0];
      l[1] = l[1] * corr[1] + rs[1];
      if (nv < TK) zero_dead_rows(kb, 0, nv, t);
      split_p(s, ph, pl);
      hand_over(n, corr[0], corr[1]);
      prev = st;
    }
    wgmma_fence();
    pv_product(acc, ph, pl, ring + prev * STAGE_BYTES, 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    release(empty(prev));
  } else if (c == 1) {
    int n = 0;
    for (int tau = first; tau < walk.end;
         tau = uniform(walk.next(tau + 1)), ++n) {
      const int st = n % stages, nv = uniform(walk.keys(tau));
      const uint32_t kb = ring + st * STAGE_BYTES;
      const int k = n & 1;
      mbar_wait(p_full(k), (n >> 1) & 1);
      const uint32_t slot = pbuf + k * P_SLOT;
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t a = slot + (((kk * 4 + j) * 128 + t) << 2);
          asm volatile("ld.shared.b32 %0, [%1];\n"
                       : "=r"(ph[kk][j])
                       : "r"(a)
                       : "memory");
          asm volatile("ld.shared.b32 %0, [%1];\n"
                       : "=r"(pl[kk][j])
                       : "r"(a + P_FRAGS / 2)
                       : "memory");
        }
      float corr[2];
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(corr[0]), "=f"(corr[1])
                   : "r"(slot + P_FRAGS + 8 * t)
                   : "memory");
      release(p_empty(k));
      rescale(acc, corr);
      mbar_wait(full(st), (n / stages) & 1);   // complete: P came after
      if (nv < TK) zero_dead_rows(kb, 1, nv, t);
      wgmma_fence();
      pv_product(acc, ph, pl, kb, 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      release(empty(st));
    }
  }
  if (c == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }

  using ML = MlLayout<WG_HEADS>;
  if (n_live == 1) {
    // range 0 holds every live key: acc / l straight from the registers
    // (consumer 1 takes its rows' l from consumer 0 through shared memory)
    if (c == 0 && tq == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) ml[ML::OWN_L + 16 * warp + g + 8 * r] = l[r];
    named_bar(1, 256);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = 1.f / fmaxf(ml[ML::OWN_L + 16 * warp + g + 8 * r], 1e-37f);
#pragma unroll
    for (int i2 = 0; i2 < 64; ++i2) {
      const int row = 16 * warp + g + 8 * (i2 & 1);
      const float inv = l[i2 & 1];
      if (row < rows_valid)
        *reinterpret_cast<__nv_bfloat162*>(
            out + row * LORA + 256 * c + 8 * (i2 >> 1) + 2 * tq) =
            __floats2bfloat162_rn(acc[2 * i2] * inv, acc[2 * i2 + 1] * inv);
    }
    return;
  }
  // stage the partial state over Q and the ring (every wgmma that read
  // them has completed in both consumers), then merge
  named_bar(1, 256);
  if (any) {
    float* acc_g = reinterpret_cast<float*>(gbase);
#pragma unroll
    for (int i2 = 0; i2 < 64; ++i2) {
      const int row = 16 * warp + g + 8 * (i2 & 1);
      const int col = 256 * c + 8 * (i2 >> 1) + 2 * tq;
      *reinterpret_cast<float2*>(acc_g + row * ACC_STRIDE + col) =
          make_float2(acc[2 * i2], acc[2 * i2 + 1]);
    }
  }
  if (c == 0 && tq == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ml[ML::OWN_M + 16 * warp + g + 8 * r] = m[r];
      ml[ML::OWN_L + 16 * warp + g + 8 * r] = l[r];
    }
  cluster_sync();                // every block's partial state is staged
  merge_ranges<__nv_bfloat16, WG_HEADS, true>(base, ml_s, ml, n_live, cols,
                                              rank, t + 128 * c, 256, 1, out,
                                              rows_valid);
  cluster_sync();                // no block leaves while a peer reads it
}

// ---------------------------------------------------------------------------
// SIMT route: fp32 q over fp32 or bf16 pools
// ---------------------------------------------------------------------------
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

// One block: range blockIdx.x, head tile blockIdx.y (16 heads), row
// blockIdx.z.  Shared memory (offsets from the plan): the scaled query
// tile [16][DQ] fp32 at 0 (after the walk the staged accumulator),
// the key tile [TK][DQ + 16 bytes] in the pool's type at
// off_keys, scores [16][TK] at off_ss, probabilities [TK][16] at off_pp,
// the (m, l) block at off_ml.
template <typename TKV>
__global__ void __launch_bounds__(SIMT_THREADS, 2)
mla_decode_simt(const float* __restrict__ q, const TKV* __restrict__ ckv,
                const TKV* __restrict__ krope, const int* __restrict__ pt,
                const int* __restrict__ posq, float* __restrict__ o, int H,
                int ps, int pps, int n_pool, int ntp, int tpr, int cols,
                int off_keys, int off_ss, int off_pp, int off_ml,
                float scale) {
  constexpr int HT = SIMT_HEADS;
  constexpr int RS = DQ + 16 / (int)sizeof(TKV);   // padded key row
  constexpr int EPC = 16 / sizeof(TKV);            // elements per 16 bytes
  constexpr int CPK_L = LORA / EPC, CPK = DQ / EPC;   // chunks per key row
  static_assert(LORA == 2 * SIMT_THREADS, "P.V gives each thread 2 dims");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  TKV* ks = reinterpret_cast<TKV*>(smem_raw + off_keys);
  float* ss = reinterpret_cast<float*>(smem_raw + off_ss);
  float* pp = reinterpret_cast<float*>(smem_raw + off_pp);   // [TK][HT]
  float* ml = reinterpret_cast<float*>(smem_raw + off_ml);
  using ML = MlLayout<HT>;
  float* m_s = ml + ML::OWN_M;
  float* l_s = ml + ML::OWN_L;
  float* c_s = ml + ML::CORR;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x, n_split = gridDim.x;
  const int h0 = blockIdx.y * HT, b = blockIdx.z;
  const int rows_valid = min(HT, H - h0);
  float* out = o + ((size_t)b * H + h0) * LORA;
  const int pos = posq[b];
  if (pos < 0) {
    if (rank == 0)
      for (int i = tid; i < rows_valid * LORA / 4; i += SIMT_THREADS)
        store4(out + 4 * i, make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }
  const int last = last_tile(pos, ps, pps, ntp);
  const int n_live = min(n_split, last / tpr + 1);
  if (n_live == 1 && rank > 0) return;
  const int tau0 = rank * tpr;
  const Walk walk{pt + (size_t)b * pps, ps, ntp, pos, n_pool,
                  min(tau0 + tpr, last + 1)};
  const bool any = walk.next(tau0) < walk.end;

  if (any)
    for (int idx = tid; idx < HT * DQ; idx += SIMT_THREADS) {
      const int h = idx / DQ;
      qs[idx] = h0 + h < H ? q[((size_t)b * H + h0) * DQ + idx] * scale
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
  __syncthreads();

  for (int tau = walk.next(tau0); tau < walk.end; tau = walk.next(tau + 1)) {
    const int tn = walk.keys(tau);               // live keys of the tile
    const size_t row0 = (size_t)walk.entry(tau) * ps + walk.slot(tau);
    const TKV* cpage = ckv + row0 * LORA;
    const TKV* rpage = krope + row0 * RD;
    // keys [ckv ‖ krope] of the tile into shared memory, 16 bytes a chunk;
    // dead slots are zero-filled
    for (int idx = tid; idx < TK * CPK; idx += SIMT_THREADS) {
      const int t = idx / CPK, ch = idx - t * CPK;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < tn) {
        const TKV* src = ch < CPK_L
                             ? cpage + (size_t)t * LORA + ch * EPC
                             : rpage + (size_t)t * RD + (ch - CPK_L) * EPC;
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
      for (int gq = 0; gq < HT / 4; ++gq) {
        const float4 p4 = pr[gq];
        acc[4 * gq][0] = fmaf(p4.x, v.x, acc[4 * gq][0]);
        acc[4 * gq][1] = fmaf(p4.x, v.y, acc[4 * gq][1]);
        acc[4 * gq + 1][0] = fmaf(p4.y, v.x, acc[4 * gq + 1][0]);
        acc[4 * gq + 1][1] = fmaf(p4.y, v.y, acc[4 * gq + 1][1]);
        acc[4 * gq + 2][0] = fmaf(p4.z, v.x, acc[4 * gq + 2][0]);
        acc[4 * gq + 2][1] = fmaf(p4.z, v.y, acc[4 * gq + 2][1]);
        acc[4 * gq + 3][0] = fmaf(p4.w, v.x, acc[4 * gq + 3][0]);
        acc[4 * gq + 3][1] = fmaf(p4.w, v.y, acc[4 * gq + 3][1]);
      }
    }
    __syncthreads();   // ks, ss, pp and c_s are rewritten by the next tile
  }

  if (n_live == 1) {             // range 0 alone: acc / l straight out
#pragma unroll
    for (int h = 0; h < HT; ++h) {
      const float inv = 1.f / fmaxf(l_s[h], 1e-37f);
      if (h < rows_valid)
        *reinterpret_cast<float2*>(out + h * LORA + d0) =
            make_float2(acc[h][0] * inv, acc[h][1] * inv);
    }
    return;
  }
  // stage the partial accumulator over the query tile (read for the last
  // time before the loop's final barrier), then merge
  if (any)
#pragma unroll
    for (int h = 0; h < HT; ++h)
      *reinterpret_cast<float2*>(qs + h * ACC_STRIDE + d0) =
          make_float2(acc[h][0], acc[h][1]);
  cluster_sync();
  merge_ranges<float, HT, false>(smem_u32(qs), smem_u32(ml), ml, n_live, cols,
                              rank, tid, SIMT_THREADS, 1, out, rows_valid);
  cluster_sync();
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
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

// A (P, ps, cols) bf16 pool as a 3-D map, innermost first: (cols, ps, P),
// boxes of (64, TK, 1) with the 128-byte swizzle that the wgmma
// descriptors read.  A box never crosses a page: slots past ps arrive as
// zeros.  Maps are kept per (device, pointer, pages, page size, cols) in
// a small ring (one stream a device, as the engine runs), so the pools of
// an engine are encoded once.
const CUtensorMap* pool_map(EncodeTiledFn enc, int dev, const void* ptr,
                            int P, int ps, int cols) {
  struct Entry {
    int dev, P, ps, cols;
    const void* ptr;
    CUtensorMap map;
  };
  constexpr int N = 32;
  static Entry cache[N];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.ptr == ptr && e.dev == dev && e.P == P && e.ps == ps &&
        e.cols == cols)
      return &e.map;
  }
  Entry& e = cache[next];
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)ps,
                              (cuuint64_t)P};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)ps * cols * 2};
  const cuuint32_t box[3] = {64, TK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (enc(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
          dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    e.ptr = nullptr;
    return nullptr;
  }
  e.dev = dev;
  e.P = P;
  e.ps = ps;
  e.cols = cols;
  e.ptr = ptr;
  next = (next + 1) % N;
  if (used < N) ++used;
  return &e.map;
}

// The plan's decomposition: n_split ranges (one cluster) of tpr tiles for
// each (row, head tile).
struct Plan {
  int B, H, ps, pps, n_pool, ht, n_split, tpr, ntp, stages, cols, off[4],
      smem;
};

cudaLaunchConfig_t launch_config(const Plan& p, int threads,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_split, (p.H + p.ht - 1) / p.ht, p.B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.n_split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The dynamic shared-memory limit of a kernel, raised once per device (a
// host call at every launch costs time that a short kernel shows); each
// kernel's function type is its own instantiation, with its own flags.
template <typename K>
int raise_smem_once(K kernel) {
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
  return 0;
}

int launch_wgmma(const void* q, const void* ckv, const void* krope,
                 const void* pt, const void* pos, void* o, const Plan& p,
                 float scale, cudaStream_t stream) {
  int rc = raise_smem_once(mla_decode_wgmma);
  if (rc) return rc;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  int dev = 0;
  cudaGetDevice(&dev);
  // copied out at once: the second lookup may reuse the first's entry
  const CUtensorMap* found = pool_map(enc, dev, ckv, p.n_pool, p.ps, LORA);
  if (found == nullptr) return (int)cudaErrorInvalidValue;
  const CUtensorMap cm = *found;
  found = pool_map(enc, dev, krope, p.n_pool, p.ps, RD);
  if (found == nullptr) return (int)cudaErrorInvalidValue;
  const CUtensorMap rm = *found;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, WG_THREADS, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, mla_decode_wgmma, cm, rm,
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(pt),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(o), p.H, p.ps,
      p.pps, p.n_pool, p.ntp, p.tpr, p.stages, p.cols, p.off[0], p.off[1],
      p.off[2], p.off[3], scale * LOG2E);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TKV>
int launch_simt(const void* q, const void* ckv, const void* krope,
                const void* pt, const void* pos, void* o, const Plan& p,
                float scale, cudaStream_t stream) {
  int rc = raise_smem_once(mla_decode_simt<TKV>);
  if (rc) return rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, SIMT_THREADS, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, mla_decode_simt<TKV>, static_cast<const float*>(q),
      static_cast<const TKV*>(ckv), static_cast<const TKV*>(krope),
      static_cast<const int*>(pt), static_cast<const int*>(pos),
      static_cast<float*>(o), p.H, p.ps, p.pps, p.n_pool, p.ntp, p.tpr, p.cols,
      p.off[0], p.off[1], p.off[2], p.off[3], scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The most clusters of ``cluster`` blocks of ``smem`` bytes that the
// current card holds at once, for the kernel that serves q and pool types
// qdt / kvdt (codes as below): clusters of 8 blocks of 200 KB must find 8
// free SMs in one GPC, so the count is below n_sm / cluster.  A negative
// return is a CUDA error code, or -1 for an unsupported type or size.
extern "C" int mla_decode_cluster_slots(int qdt, int kvdt, int cluster,
                                        int smem) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0, rc = 0;
  cudaError_t err = cudaSuccess;
  if (qdt == 1 && kvdt == 1) {
    rc = raise_smem_once(mla_decode_wgmma);
    cfg.blockDim = dim3(WG_THREADS);
    if (!rc) err = cudaOccupancyMaxActiveClusters(&n, mla_decode_wgmma, &cfg);
  } else if (qdt == 0 && (kvdt == 0 || kvdt == 1)) {
    cfg.blockDim = dim3(SIMT_THREADS);
    if (kvdt == 0) {
      rc = raise_smem_once(mla_decode_simt<float>);
      if (!rc)
        err = cudaOccupancyMaxActiveClusters(&n, mla_decode_simt<float>,
                                             &cfg);
    } else {
      rc = raise_smem_once(mla_decode_simt<__nv_bfloat16>);
      if (!rc)
        err = cudaOccupancyMaxActiveClusters(
            &n, mla_decode_simt<__nv_bfloat16>, &cfg);
    }
  } else {
    return -1;
  }
  if (rc) return rc > 0 ? -rc : rc;
  return err == cudaSuccess ? n : -(int)err;
}

// qdt / kvdt: 0 = float32, 1 = bfloat16 (q and o share qdt; a float32 q
// over bfloat16 pools is the fp32-compute / bf16-cache configuration).
// The decomposition (ht heads a block, n_split ranges of tpr tiles, ntp
// tiles a page, ring stages, cols latent columns a block merges) and the
// shared-memory layout (off0..off3,
// smem bytes) are paged_attention.mla_decode_plan's, passed as they are:
// for bf16 q over bf16 pools the ring, P slots, (m, l) block and
// mbarriers; otherwise the key tile, scores, probabilities and (m, l)
// block.  All operands contiguous, pools 16-byte aligned.  Returns 0 when
// the kernel was launched, a CUDA error code when the launch was refused,
// -1 for an unsupported shape, type or plan.
extern "C" int mla_decode_fwd(const void* q, const void* ckv,
                              const void* krope, const void* pt,
                              const void* pos, void* o, int qdt, int kvdt,
                              int B, int H, int lora, int rd, int ps,
                              int pps, int n_pool, int ht, int n_split,
                              int tpr, int ntp, int stages, int cols,
                              int off0, int off1, int off2, int off3,
                              int smem, float scale, void* stream) {
  if (B <= 0 || H <= 0 || ps <= 0 || pps <= 0 || n_pool <= 0 ||
      lora != LORA || rd != RD || n_split < 1 || n_split > MAX_CLUSTER ||
      tpr < 1 || ntp != (ps + TK - 1) / TK || n_split * tpr < pps * ntp ||
      cols < 4 || cols % 4 || n_split * cols < LORA)
    return -1;
  const Plan p{B, H, ps, pps, n_pool, ht, n_split, tpr, ntp, stages, cols,
               {off0, off1, off2, off3}, smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qdt == 1 && kvdt == 1) {
    if (ht != WG_HEADS || stages < 1 || stages > 3) return -1;
    return launch_wgmma(q, ckv, krope, pt, pos, o, p, scale, st);
  }
  if (ht != SIMT_HEADS) return -1;
  if (qdt == 0 && kvdt == 0)
    return launch_simt<float>(q, ckv, krope, pt, pos, o, p, scale, st);
  if (qdt == 0 && kvdt == 1)
    return launch_simt<__nv_bfloat16>(q, ckv, krope, pt, pos, o, p, scale,
                                      st);
  return -1;
}
