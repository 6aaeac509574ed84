// RG-LRU linear recurrence for Hopper, sm_90a.
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/rglru_scan.py:_rglru_kernel, called through
// kernels/ops.py:rglru_scan_bsr from models/recurrent.py:rglru_block (every
// prefill of every recurrent layer).
//
// What it computes, per channel (b, r), in fp32:
//   h_t = exp(log_a_t) * h_{t-1} + b_t,     h_{-1} = h0 (zero when absent)
// log_a, b (B, S, R) fp32; h0 (B, R) fp32 or null; out h (B, S, R) fp32.
//
// rglru_scan_bwd, the backward (no TPU kernel: the reference trains through
// jax.grad of its jnp associative scan, models/recurrent.py:
// rglru_scan_assoc), per channel in fp32, walking t in reverse with the
// carry g in a register (g past the last step = 0):
//   g_t = dh_t + exp(log_a_{t+1}) * g_{t+1}        (one fused multiply-add)
//   db_t = g_t,  dlog_a_t = g_t * exp(log_a_t) * h_{t-1}
//   dh0 = exp(log_a_0) * g_0                       (h_{-1} = h0, or 0)
// h_{t-1} comes from the forward's output (h_t - b_t would cancel).
//
// What bounds them: the recurrence is elementwise, so bytes.  The forward
// reads log_a and b once and writes h once (12 B a step and channel), the
// backward reads log_a, h_{t-1} and dh and writes dlog_a and db (20 B).
// To stream at the card's 3.35 TB/s with about a microsecond of memory
// latency, every SM needs tens of KB of loads in flight.  A thread that
// issued its own loads a few steps ahead of its chain kept 16 KB in flight
// a block of 128 channels, and at a training microbatch (B 1, R 4,096:
// 4,096 chains) that left a quarter of the SMs streaming.
//
// Design: each channel is still one chain, walked in order (the backward in
// reverse) by one thread with the carry in a register, with the same
// expf and fused multiply-add as the plain version's step; so a channel's
// result depends on that channel alone and not on how the work is cut.
// A block owns C = 32, 64 or 128 channels of one batch row and has three
// roles: a producer warp, C / 32 exponential warps and C / 32 walk warps.
// The producer keeps a ring of `stages` stages in shared memory, each a
// (steps x C) tile of every input, the forward's tiles in order, the
// backward's in reverse.  Two copy paths fill it:
//   TMA (cp.async.bulk.tensor) from 3-D tensor maps (R, S, B), one box of
//     (C, steps, 1) an input, so a box never crosses a batch row and steps
//     past S or channels past R arrive as zeros; needs 16-byte row strides
//     (R % 4 == 0) and 16-byte aligned operands;
//   otherwise 4-byte cp.async copies by the producer warp's 32 lanes,
//     zero-filled past S and R, whose completion the full barrier tracks
//     (cp.async.mbarrier.arrive.noinc).
// An exponential warp turns its 32 channels' log_a tile into exp(log_a) in
// place (expf, the value the walk used to compute itself), and a walk
// warp then runs the chain: a step is two or three shared-memory reads,
// one fused multiply-add (and the backward's two products) and streaming
// stores, predicated for channels past R.  A walk warp that took its own
// exponentials issued about 20 instructions a step and, alone on its SM
// quarter at a batch of one, set the pace; split, neither does.  Barriers
// a stage: full (the tiles landed), ready (exponentials taken), empty
// (walked).  h_{t-1}'s tile is taken one step earlier than log_a's and has
// one spare row: the tile at t0 = 0 lands one row down and its first row
// is h0 (or 0), written by the walk thread that reads it.  The plan
// (kernels/rglru_scan.py:rglru_plan) picks C so that B x ceil(R / C)
// blocks cover the SMs (B 1, R 4,096: C 32, 128 blocks), and steps and
// stages so that an SM holds about 96 KB of loads in flight within its
// shared memory.  A padding step (log_a = 0, b = 0) computes
// fmaf(expf(0), h, 0) = h in the forward and passes g on with a factor 1
// in the backward: the carry is left exactly as it was.  No atomics: two
// calls are bit-equal.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_STAGES = 8;
constexpr int MAX_STEPS = 256;      // a TMA box's largest dimension
constexpr int SMEM_LIMIT = 232448;  // shared memory a block can use
constexpr int ALIGN = 128;          // TMA destinations are 128-byte aligned
constexpr int UNROLL = 16;          // steps of a walk unrolled together

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
// One (C, steps, 1) box of a 3-D map (R, S, B) at (r0, t, row).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int r0, int t,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(r0), "r"(t),
      "r"(row), "r"(bar)
      : "memory");
}
// 4 bytes from src to dst, or 4 zero bytes when !ok (src is not read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
// The barrier's pending count falls by one when every cp.async this thread
// issued before has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Shared memory of a block: the ring's stages, then the full, ready and
// empty barriers.  A stage holds a (steps x C) fp32 tile of each input (two
// forward, three backward), the backward's h_{t-1} tile one row more.
__host__ __device__ __forceinline__ int stage_bytes(int C, int steps,
                                                   bool bwd) {
  return ((bwd ? 3 : 2) * steps + (bwd ? 1 : 0)) * C * 4;
}
__host__ __device__ __forceinline__ int smem_bytes(int C, int steps,
                                                  int stages, bool bwd) {
  return ALIGN + stages * stage_bytes(C, steps, bwd) + 3 * stages * 8;
}

// The block's roles and its barriers.  Warp 0 produces; warps 1 .. W
// (W = C / 32) walk channels 32 (w - 1) .. 32 w - 1; warps W + 1 .. 2 W
// take the exponentials of the same channels' log_a tile in place, so
// that a walk is a chain of loads, one fused multiply-add and stores.
// Stage s: full (the tiles landed), ready (exponentials taken), empty
// (walked).
struct Ring {
  float* ring;
  uint32_t bars;
  int stages;
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t ready(int s) const { return bars + 8 * (stages + s); }
  __device__ uint32_t empty(int s) const {
    return bars + 8 * (2 * stages + s);
  }
};

// The producer warp's loop over a block's tiles: the forward's in order,
// the backward's in reverse.  ``maps`` / ``src`` hold the inputs (the
// forward's log_a and b; the backward's log_a, dh and h); input i lands at
// offset i * steps * C floats of its stage.  The backward's last input,
// h_{t-1}, is read one step earlier and, at t0 = 0, lands one row down.
template <bool TMA, int C, bool BWD>
__device__ __forceinline__ void produce(const CUtensorMap* const* maps,
                                        const float* const* src,
                                        const Ring& rg, int S, int R,
                                        int steps) {
  constexpr int n_in = BWD ? 3 : 2;
  const int lane = threadIdx.x & 31;
  if (TMA && lane != 0) return;        // one thread issues the boxes
  const int row = blockIdx.y, r0 = blockIdx.x * C;
  const int tiles = (S + steps - 1) / steps;
  const int tile = steps * C;
  const int stage_f = stage_bytes(C, steps, BWD) / 4;
  for (int k = 0; k < tiles; ++k) {
    const int s = k % rg.stages, n = k / rg.stages;
    const int t0 = (BWD ? tiles - 1 - k : k) * steps;
    const uint32_t full = rg.full(s), empty = rg.empty(s);
    float* st = rg.ring + (size_t)s * stage_f;
    if (TMA) {
      if (k >= rg.stages) mbar_wait(empty, (n - 1) & 1);
      mbar_expect_tx(full, n_in * tile * 4);
#pragma unroll
      for (int i = 0; i < n_in; ++i) {
        const int shift = BWD && i == n_in - 1 ? 1 : 0;
        const int down = shift && t0 == 0 ? 1 : 0;
        tma_load(smem_u32(st + i * tile + down * C), maps[i], full, r0,
                 t0 - shift + down, row);
      }
    } else {
      if (k >= rg.stages) mbar_wait(empty, (n - 1) & 1);
#pragma unroll
      for (int i = 0; i < n_in; ++i) {
        const int shift = BWD && i == n_in - 1 ? 1 : 0;
        const int down = shift && t0 == 0 ? 1 : 0;
        const int t_first = t0 - shift + down;
        const float* base = src[i] + (size_t)row * S * R;
        const uint32_t dst = smem_u32(st + i * tile + down * C);
        // a lane copies channels lane, lane + 32, ... of every step row
#pragma unroll
        for (int w = 0; w < C / 32; ++w) {
          const int c = lane + 32 * w;
          const bool live = r0 + c < R;
          for (int q = 0; q < steps; ++q) {
            const int t = t_first + q;
            const bool ok = live && t >= 0 && t < S;
            cp_async4(dst + 4 * (q * C + c),
                      ok ? base + (size_t)t * R + r0 + c : base, ok);
          }
        }
      }
      cp_async_arrive(full);
    }
  }
  if (!TMA) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A streaming store (evict-first) of a live channel's value.  Predicated
// inside the instruction, not by a branch, and without a memory clobber:
// the compiler may then issue later shared-memory reads ahead of it and
// keep a walk's steps in one basic block.
__device__ __forceinline__ void st_stream(float* p, float v, bool live) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p st.global.cs.f32 [%0], %1;\n}\n" ::"l"(p),
      "f"(v), "r"((int)live));
}

template <bool TMA, int C>
__device__ __forceinline__ Ring make_ring(unsigned char* smem_raw,
                                          int stage_f, int stages) {
  // pointer arithmetic on the shared array (not on an integer), so the
  // compiler keeps the walks' reads as shared-memory loads
  float* ring = reinterpret_cast<float*>(
      smem_raw + (ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN);
  const Ring rg{ring, smem_u32(ring + (size_t)stages * stage_f), stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(rg.full(s), TMA ? 1 : 32);
      mbar_init(rg.ready(s), C / 32);
      mbar_init(rg.empty(s), C / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return rg;
}

// An exponential warp: log_a's tile of its 32 channels becomes exp(log_a)
// in place, every stage, in the producer's order (the tile at t0 in
// reverse for the backward).
template <int C, bool BWD>
__device__ __forceinline__ void take_exps(const Ring& rg, int c, int S,
                                          int steps, int stage_f) {
  const int tiles = (S + steps - 1) / steps;
  for (int k = 0; k < tiles; ++k) {
    const int s = k % rg.stages, n = k / rg.stages;
    const int t0 = (BWD ? tiles - 1 - k : k) * steps;
    const int cnt = min(steps, S - t0);
    mbar_wait(rg.full(s), n & 1);
    float* pa = rg.ring + (size_t)s * stage_f + c;
#pragma unroll 8
    for (int i = 0; i < cnt; ++i) pa[i * C] = expf(pa[i * C]);
    // these writes come before the next copy into the slot (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(rg.ready(s));
  }
}

template <bool TMA, int C>
__global__ void __launch_bounds__(2 * C + 32)
rglru_scan_kernel(const __grid_constant__ CUtensorMap la_map,
                  const __grid_constant__ CUtensorMap b_map,
                  const float* __restrict__ log_a,
                  const float* __restrict__ b, const float* __restrict__ h0,
                  float* __restrict__ out, int S, int R, int steps,
                  int stages) {
  extern __shared__ unsigned char smem_raw[];
  const int tile = steps * C;
  const int stage_f = stage_bytes(C, steps, false) / 4;
  const Ring rg = make_ring<TMA, C>(smem_raw, stage_f, stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    const CUtensorMap* maps[2] = {&la_map, &b_map};
    const float* src[2] = {log_a, b};
    produce<TMA, C, false>(maps, src, rg, S, R, steps);
    return;
  }
  if (warp > C / 32) {
    take_exps<C, false>(rg, (warp - 1 - C / 32) * 32 + lane, S, steps,
                        stage_f);
    return;
  }
  const int c = (warp - 1) * 32 + lane;
  const int r = blockIdx.x * C + c;
  const bool live = r < R;
  const size_t row = blockIdx.y;
  float h = h0 != nullptr && live ? h0[row * R + r] : 0.f;
  float* po = out + row * S * R + r;
  const int tiles = (S + steps - 1) / steps;
  for (int k = 0; k < tiles; ++k) {
    const int s = k % stages, n = k / stages;
    mbar_wait(rg.ready(s), n & 1);
    const float* pa = rg.ring + (size_t)s * stage_f + c;   // exp(log_a)
    const float* pb = pa + tile;
    const int t0 = k * steps, cnt = min(steps, S - t0);
    float* o = po + (size_t)t0 * R;
    int i = 0;
    for (; i + UNROLL <= cnt; i += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        h = fmaf(pa[(i + u) * C], h, pb[(i + u) * C]);
        st_stream(o + (size_t)(i + u) * R, h, live);
      }
    }
    for (; i < cnt; ++i) {
      h = fmaf(pa[i * C], h, pb[i * C]);
      st_stream(o + (size_t)i * R, h, live);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(rg.empty(s));
  }
}

template <bool TMA, int C>
__global__ void __launch_bounds__(2 * C + 32)
rglru_scan_bwd_kernel(const __grid_constant__ CUtensorMap la_map,
                      const __grid_constant__ CUtensorMap dh_map,
                      const __grid_constant__ CUtensorMap h_map,
                      const float* __restrict__ log_a,
                      const float* __restrict__ h,
                      const float* __restrict__ dh,
                      const float* __restrict__ h0,
                      float* __restrict__ dlog_a, float* __restrict__ db,
                      float* __restrict__ dh0, int S, int R, int steps,
                      int stages) {
  extern __shared__ unsigned char smem_raw[];
  const int tile = steps * C;
  const int stage_f = stage_bytes(C, steps, true) / 4;
  const Ring rg = make_ring<TMA, C>(smem_raw, stage_f, stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    // stage layout: log_a, dh, then h_{t-1} (one row more)
    const CUtensorMap* maps[3] = {&la_map, &dh_map, &h_map};
    const float* src[3] = {log_a, dh, h};
    produce<TMA, C, true>(maps, src, rg, S, R, steps);
    return;
  }
  if (warp > C / 32) {
    take_exps<C, true>(rg, (warp - 1 - C / 32) * 32 + lane, S, steps,
                       stage_f);
    return;
  }
  const int c = (warp - 1) * 32 + lane;
  const int r = blockIdx.x * C + c;
  const bool live = r < R;
  const size_t row = blockIdx.y;
  const float h_first = h0 != nullptr && live ? h0[row * R + r] : 0.f;
  float* pla = dlog_a + row * S * R + r;
  float* pdb = db + row * S * R + r;
  float g = 0.f, a_next = 0.f;   // the carry and exp(log_a_{t+1})
  const int tiles = (S + steps - 1) / steps;
  for (int k = 0; k < tiles; ++k) {
    const int s = k % stages, n = k / stages;
    mbar_wait(rg.ready(s), n & 1);
    float* st = rg.ring + (size_t)s * stage_f;
    const float* pa = st + c;                 // exp(log_a)
    const float* pd = st + tile + c;
    float* hp = st + 2 * tile + c;            // row i: h_{t0 + i - 1}
    const int t0 = (tiles - 1 - k) * steps, cnt = min(steps, S - t0);
    // the last tile walked: this thread's own h_{-1}, read by it alone
    // and never refilled
    if (t0 == 0) hp[0] = h_first;
    float* ola = pla + (size_t)t0 * R;
    float* odb = pdb + (size_t)t0 * R;
    // the ragged part of a tile (its last cnt mod UNROLL steps) first
    int i = cnt;
    for (; i % UNROLL != 0; --i) {
      const int j = i - 1;
      const float a = pa[j * C];
      g = fmaf(a_next, g, pd[j * C]);
      st_stream(odb + (size_t)j * R, g, live);
      st_stream(ola + (size_t)j * R, g * a * hp[j * C], live);
      a_next = a;
    }
    for (; i > 0; i -= UNROLL) {
#pragma unroll
      for (int u = 1; u <= UNROLL; ++u) {
        const int j = i - u;
        const float a = pa[j * C];
        g = fmaf(a_next, g, pd[j * C]);
        st_stream(odb + (size_t)j * R, g, live);
        st_stream(ola + (size_t)j * R, g * a * hp[j * C], live);
        a_next = a;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(rg.empty(s));
  }
  if (dh0 != nullptr && live) dh0[row * R + r] = a_next * g;
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

// A (B, S, R) fp32 tensor as a 3-D map, innermost first: (R, S, B), boxes
// of (C, steps, 1); what lies past S or R arrives as zeros.  Operands
// change every call, so maps are encoded per call (a few microseconds on
// the host).
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int R, int C,
              int steps) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)R, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)R * 4,
                                 (cuuint64_t)S * R * 4};
  const cuuint32_t box[3] = {(cuuint32_t)C, (cuuint32_t)steps, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The plan's fields as the kernels take them; false for one they do not.
bool plan_ok(int B, int S, int R, int C, int steps, int stages, int tma,
             bool bwd) {
  if (B <= 0 || S <= 0 || R <= 0 || B > 65535) return false;
  if (C != 32 && C != 64 && C != 128) return false;
  if (steps < 1 || steps > MAX_STEPS || stages < 1 || stages > MAX_STAGES)
    return false;
  if (tma && R % 4 != 0) return false;
  return smem_bytes(C, steps, stages, bwd) <= SMEM_LIMIT;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_LIMIT);
}

template <bool TMA, int C>
int launch_fwd(const CUtensorMap& la_map, const CUtensorMap& b_map,
               const float* log_a, const float* b, const float* h0,
               float* out, int B, int S, int R, int steps, int stages,
               cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(rglru_scan_kernel<TMA, C>);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((R + C - 1) / C, B);
  rglru_scan_kernel<TMA, C><<<grid, 2 * C + 32,
                              smem_bytes(C, steps, stages, false),
                              stream>>>(la_map, b_map, log_a, b, h0, out, S,
                                        R, steps, stages);
  return (int)cudaGetLastError();
}

template <bool TMA, int C>
int launch_bwd(const CUtensorMap& la_map, const CUtensorMap& dh_map,
               const CUtensorMap& h_map, const float* log_a, const float* h,
               const float* dh, const float* h0, float* dlog_a, float* db,
               float* dh0, int B, int S, int R, int steps, int stages,
               cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(rglru_scan_bwd_kernel<TMA, C>);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((R + C - 1) / C, B);
  rglru_scan_bwd_kernel<TMA, C><<<grid, 2 * C + 32,
                                  smem_bytes(C, steps, stages, true),
                                  stream>>>(la_map, dh_map, h_map, log_a, h,
                                            dh, h0, dlog_a, db, dh0, S, R,
                                            steps, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// log_a, b, out: (B, S, R) fp32; h0: (B, R) fp32 or null (zero state); all
// contiguous.  (C, steps, stages, tma) is the plan of
// kernels/rglru_scan.py:rglru_plan: channels a block, steps a stage, stages
// of the ring, the TMA path (else cp.async).  Returns 0 when the kernel was
// launched, a CUDA error code when the launch was refused, -1 for a shape
// or plan the kernel does not take.
extern "C" int rglru_scan_fwd(const void* log_a, const void* b,
                              const void* h0, void* out, int B, int S, int R,
                              int C, int steps, int stages, int tma,
                              void* stream) {
  if (!plan_ok(B, S, R, C, steps, stages, tma, false)) return -1;
  CUtensorMap la_map = {}, b_map = {};
  if (tma && !(aligned16(log_a) && aligned16(b) &&
               make_map(&la_map, log_a, B, S, R, C, steps) &&
               make_map(&b_map, b, B, S, R, C, steps)))
    return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* la = static_cast<const float*>(log_a);
  const auto* bb = static_cast<const float*>(b);
  const auto* hh = static_cast<const float*>(h0);
  auto* o = static_cast<float*>(out);
#define RGLRU_FWD(T, CC) \
  launch_fwd<T, CC>(la_map, b_map, la, bb, hh, o, B, S, R, steps, stages, st)
  if (tma) {
    return C == 32 ? RGLRU_FWD(true, 32)
                   : C == 64 ? RGLRU_FWD(true, 64) : RGLRU_FWD(true, 128);
  }
  return C == 32 ? RGLRU_FWD(false, 32)
                 : C == 64 ? RGLRU_FWD(false, 64) : RGLRU_FWD(false, 128);
#undef RGLRU_FWD
}

// log_a, h (the forward's output), dh, dlog_a, db: (B, S, R) fp32; h0, dh0:
// (B, R) fp32 or both null (zero state, no dh0); all contiguous.  The plan
// as for rglru_scan_fwd (rglru_plan with backward=True).  Returns 0 when
// the kernel was launched, a CUDA error code when the launch was refused,
// -1 for a shape or plan the kernel does not take.
extern "C" int rglru_scan_bwd(const void* log_a, const void* h,
                              const void* dh, const void* h0, void* dlog_a,
                              void* db, void* dh0, int B, int S, int R,
                              int C, int steps, int stages, int tma,
                              void* stream) {
  if (!plan_ok(B, S, R, C, steps, stages, tma, true)) return -1;
  if ((h0 == nullptr) != (dh0 == nullptr)) return -1;
  CUtensorMap la_map = {}, dh_map = {}, h_map = {};
  if (tma && !(aligned16(log_a) && aligned16(h) && aligned16(dh) &&
               make_map(&la_map, log_a, B, S, R, C, steps) &&
               make_map(&dh_map, dh, B, S, R, C, steps) &&
               make_map(&h_map, h, B, S, R, C, steps)))
    return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* la = static_cast<const float*>(log_a);
  const auto* hh = static_cast<const float*>(h);
  const auto* dd = static_cast<const float*>(dh);
  const auto* h0f = static_cast<const float*>(h0);
  auto* ola = static_cast<float*>(dlog_a);
  auto* odb = static_cast<float*>(db);
  auto* odh0 = static_cast<float*>(dh0);
#define RGLRU_BWD(T, CC)                                                    \
  launch_bwd<T, CC>(la_map, dh_map, h_map, la, hh, dd, h0f, ola, odb, odh0, \
                    B, S, R, steps, stages, st)
  if (tma) {
    return C == 32 ? RGLRU_BWD(true, 32)
                   : C == 64 ? RGLRU_BWD(true, 64) : RGLRU_BWD(true, 128);
  }
  return C == 32 ? RGLRU_BWD(false, 32)
                 : C == 64 ? RGLRU_BWD(false, 64) : RGLRU_BWD(false, 128);
#undef RGLRU_BWD
}
