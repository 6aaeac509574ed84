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
// Design: the TPU kernel kept the carry in VMEM across a sequential grid
// axis of t_blk = 16 steps and streamed log_a and b through once.  Here one
// thread owns one channel and walks t in order, so the carry never leaves a
// register; neighbouring threads own neighbouring r, so every load and store
// of a warp is one 128-byte row segment.  The recurrence is elementwise, so
// the kernel is bound by bytes (log_a and b read once, h written once: 12 B
// a step and channel), and a chain that waited on one load a step would be
// bound by latency instead: at the serving shape (B 8, R 4096) there are
// only 32,768 chains, about 8 warps an SM.  So each pass loads T = 16 steps
// of log_a and b into registers, and the loads of the next pass are issued
// before the FMA chain of this one: 64 loads a thread in flight.  The 16
// exponentials of a pass do not depend on h; only the FMAs chain.  S needs
// no padding (the reference wrapper padded it to t_blk): a ragged tail is a
// short last loop.  A padding step (log_a = 0, b = 0) computes
// fmaf(expf(0), h, 0) = fmaf(1, h, 0) = h: the carry is left exactly as it
// was.  Splitting t across blocks (a carry pass between chunks) to fill the
// card at small batch is later work.
//
// rglru_scan_bwd, the backward (no TPU kernel: the reference trains through
// jax.grad of its jnp associative scan, models/recurrent.py:
// rglru_scan_assoc), per channel in fp32, walking t in reverse with the
// carry g in a register (g past the last step = 0):
//   g_t = dh_t + exp(log_a_{t+1}) * g_{t+1}        (one fused multiply-add)
//   db_t = g_t,  dlog_a_t = g_t * exp(log_a_t) * h_{t-1}
//   dh0 = exp(log_a_0) * g_0                       (h_{-1} = h0, or 0)
// h_{t-1} comes from the forward's output (h_t - b_t would cancel).  It is
// bound by bytes too: log_a, h and dh read, dlog_a and db written, 20 B a
// step and channel.  Same walk as the forward, in reverse: each pass loads
// T steps of log_a, h_{t-1} and dh, the next pass's loads go out before
// this pass's chain, the ragged tail (the last S mod T steps) is walked
// first, one step at a time.  A padding step (log_a = 0) passes g on with
// a factor exp(0) = 1.  No atomics: two calls are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 16;          // steps held in registers per pass
constexpr int THREADS = 128;   // channels per block

__device__ __forceinline__ void load_pass(float (&la)[T], float (&bb)[T],
                                          const float* pa, const float* pb,
                                          size_t stride) {
#pragma unroll
  for (int i = 0; i < T; ++i) {
    la[i] = __ldcs(pa + i * stride);
    bb[i] = __ldcs(pb + i * stride);
  }
}

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int S, int R) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const size_t row = (size_t)blockIdx.y * S * R + r;
  const size_t stride = (size_t)R;
  const float* pa = log_a + row;
  const float* pb = b + row;
  float* po = out + row;
  float h = h0 != nullptr ? h0[(size_t)blockIdx.y * R + r] : 0.f;

  const int passes = S / T;
  float cur_a[T], cur_b[T];
  if (passes > 0) load_pass(cur_a, cur_b, pa, pb, stride);
  for (int p = 0; p < passes; ++p) {
    // the next pass's loads go out before this pass's chain; the last pass
    // reloads itself, so the loop body has no branch around the loads
    const size_t nxt = (size_t)min(p + 1, passes - 1) * T * stride;
    float nxt_a[T], nxt_b[T];
    load_pass(nxt_a, nxt_b, pa + nxt, pb + nxt, stride);
    float* o = po + (size_t)p * T * stride;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      h = fmaf(expf(cur_a[i]), h, cur_b[i]);
      __stcs(o + i * stride, h);
    }
#pragma unroll
    for (int i = 0; i < T; ++i) {
      cur_a[i] = nxt_a[i];
      cur_b[i] = nxt_b[i];
    }
  }
  for (int t = passes * T; t < S; ++t) {
    const size_t off = (size_t)t * stride;
    h = fmaf(expf(__ldcs(pa + off)), h, __ldcs(pb + off));
    __stcs(po + off, h);
  }
}

__device__ __forceinline__ void load_bwd_pass(float (&la)[T], float (&hp)[T],
                                              float (&dd)[T], const float* pa,
                                              const float* ph,
                                              const float* pd, size_t stride,
                                              int t0, float h_first) {
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int t = t0 + i;
    la[i] = __ldcs(pa + t * stride);
    dd[i] = __ldcs(pd + t * stride);
    hp[i] = t > 0 ? __ldcs(ph + (t - 1) * stride) : h_first;
  }
}

__global__ void __launch_bounds__(THREADS)
rglru_scan_bwd_kernel(const float* __restrict__ log_a,
                      const float* __restrict__ h,
                      const float* __restrict__ dh,
                      const float* __restrict__ h0,
                      float* __restrict__ dlog_a, float* __restrict__ db,
                      float* __restrict__ dh0, int S, int R) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const size_t row = (size_t)blockIdx.y * S * R + r;
  const size_t stride = (size_t)R;
  const float* pa = log_a + row;
  const float* ph = h + row;
  const float* pd = dh + row;
  float* pla = dlog_a + row;
  float* pdb = db + row;
  const float h_first = h0 != nullptr ? h0[(size_t)blockIdx.y * R + r] : 0.f;

  float g = 0.f, a_next = 0.f;   // the carry and exp(log_a_{t+1})
  const int passes = S / T;
  // the ragged tail first, one step at a time
  for (int t = S - 1; t >= passes * T; --t) {
    const size_t off = (size_t)t * stride;
    const float a = expf(__ldcs(pa + off));
    g = fmaf(a_next, g, __ldcs(pd + off));
    const float hp = t > 0 ? __ldcs(ph + off - stride) : h_first;
    __stcs(pdb + off, g);
    __stcs(pla + off, g * a * hp);
    a_next = a;
  }
  float cur_a[T], cur_h[T], cur_d[T];
  if (passes > 0)
    load_bwd_pass(cur_a, cur_h, cur_d, pa, ph, pd, stride, (passes - 1) * T,
                  h_first);
  for (int p = passes - 1; p >= 0; --p) {
    // the next (earlier) pass's loads go out before this pass's chain; the
    // first pass reloads itself, so the loop body has no branch around them
    float nxt_a[T], nxt_h[T], nxt_d[T];
    load_bwd_pass(nxt_a, nxt_h, nxt_d, pa, ph, pd, stride, max(p - 1, 0) * T,
                  h_first);
    const size_t base = (size_t)p * T * stride;
#pragma unroll
    for (int i = T - 1; i >= 0; --i) {
      const float a = expf(cur_a[i]);
      g = fmaf(a_next, g, cur_d[i]);
      __stcs(pdb + base + i * stride, g);
      __stcs(pla + base + i * stride, g * a * cur_h[i]);
      a_next = a;
    }
#pragma unroll
    for (int i = 0; i < T; ++i) {
      cur_a[i] = nxt_a[i];
      cur_h[i] = nxt_h[i];
      cur_d[i] = nxt_d[i];
    }
  }
  if (dh0 != nullptr) dh0[(size_t)blockIdx.y * R + r] = a_next * g;
}

}  // namespace

// log_a, b, out: (B, S, R) fp32; h0: (B, R) fp32 or null (zero state); all
// contiguous.  Returns 0 when the kernel was launched, a CUDA error code
// when the launch was refused, -1 for an unsupported shape.
extern "C" int rglru_scan_fwd(const void* log_a, const void* b,
                              const void* h0, void* out, int B, int S, int R,
                              void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || B > 65535) return -1;
  const dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), S, R);
  return (int)cudaGetLastError();
}

// log_a, h (the forward's output), dh, dlog_a, db: (B, S, R) fp32; h0, dh0:
// (B, R) fp32 or both null (zero state, no dh0); all contiguous.  Returns 0
// when the kernel was launched, a CUDA error code when the launch was
// refused, -1 for an unsupported shape.
extern "C" int rglru_scan_bwd(const void* log_a, const void* h,
                              const void* dh, const void* h0, void* dlog_a,
                              void* db, void* dh0, int B, int S, int R,
                              void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || B > 65535) return -1;
  if ((h0 == nullptr) != (dh0 == nullptr)) return -1;
  const dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_scan_bwd_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(h),
      static_cast<const float*>(dh), static_cast<const float*>(h0),
      static_cast<float*>(dlog_a), static_cast<float*>(db),
      static_cast<float*>(dh0), S, R);
  return (int)cudaGetLastError();
}
