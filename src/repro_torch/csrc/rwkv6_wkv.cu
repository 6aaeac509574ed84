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
// rounded once, and s_fin (B, H, N, N) fp32.  All arithmetic is fp32.
//
// Design: the per-column recurrence.  The TPU walked chunks of 32 steps as
// a sequential grid axis, the state in VMEM, and formed the intra-chunk
// pairs as (L, L, N) decay tiles.  Here one block of N threads owns one
// (b, h); thread j keeps column S[:, j] in registers and walks the steps in
// order.  Each pass stages T = 32 steps of r, k, v and exp(lw) in shared
// memory (one coalesced row of N values per step and array), plus the
// bonus r_t . (u (*) k_t), summed once per step.  Then, per step, thread j
// computes o_t[j] = sum_c r_t[c] S[c, j] + bonus_t v_t[j] from the old
// column and updates S[c, j] = exp(lw_t[c]) S[c, j] + k_t[c] v_t[j]; the
// r, k and exp(lw) rows are broadcast reads of shared memory.  The kernel
// reads the model layout through its strides (step stride H * N), so the
// reference wrapper's fold, transpose and chunk padding are gone, and a
// ragged S is a shorter last pass.  A step with k = 0 and lw = 0 (ragged
// padding) computes S = fmaf(1, S, 0) = S: the state is left exactly as it
// was.
//
// Bound on the card: per step and head the recurrence does 5 N^2 fp32
// operations (the r . S read-out, the decay and the k v^T write), against
// about 12 N bytes moved, so at N = 64 it is bound by the fp32 rate
// (67 TFLOP/s outside the tensor cores), not by memory.  The kernel does
// those operations and no others on its state: 3 instructions a state
// element a step, issued from registers.  At the serving shape (B 8, H 64)
// that is 512 blocks of 64 threads, about 4 blocks an SM on 132 SMs.  It
// is serial in S within a block; tensor cores (the chunked form as
// matrix products), TMA and a split of a column over several threads are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 32;   // steps staged in shared memory per pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename TI> __device__ __forceinline__ TI from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

template <typename TI, int N>
__global__ void __launch_bounds__(N) wkv6_kernel(
    const TI* __restrict__ r, const TI* __restrict__ k,
    const TI* __restrict__ v, const float* __restrict__ lw,
    const float* __restrict__ u, const float* __restrict__ s0,
    TI* __restrict__ o, float* __restrict__ s_fin, int S, int H) {
  static_assert(N % 4 == 0 && N <= 1024, "N");
  __shared__ __align__(16) float rs[T][N];
  __shared__ __align__(16) float ks[T][N];
  __shared__ __align__(16) float ws[T][N];
  __shared__ float vs[T][N];
  __shared__ float ps[T][N + 1];   // r u k products; rows summed, padded
  __shared__ float bonus[T];

  const int bh = blockIdx.x;        // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;        // state column / input channel

  float st[N];                      // S[:, j]
  const float* s0p = s0 + (size_t)bh * N * N;
#pragma unroll
  for (int c = 0; c < N; ++c) st[c] = s0p[(size_t)c * N + j];
  const float uj = u[h * N + j];

  const size_t step = (size_t)H * N;
  const size_t base = (size_t)b * S * step + (size_t)h * N + j;

  for (int t0 = 0; t0 < S; t0 += T) {
    const int n = min(T, S - t0);
    for (int t = 0; t < n; ++t) {
      const size_t off = base + (size_t)(t0 + t) * step;
      const float rv = to_f(r[off]);
      const float kv = to_f(k[off]);
      rs[t][j] = rv;
      ks[t][j] = kv;
      vs[t][j] = to_f(v[off]);
      ws[t][j] = expf(lw[off]);
      ps[t][j] = rv * uj * kv;
    }
    __syncthreads();
    for (int t = j; t < n; t += N) {
      float a = 0.f;
#pragma unroll 8
      for (int c = 0; c < N; ++c) a += ps[t][c];
      bonus[t] = a;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = vs[t][j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int c = 0; c < N; c += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[t][c]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[t][c]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[t][c]);
        a0 = fmaf(r4.x, st[c], a0);
        a1 = fmaf(r4.y, st[c + 1], a1);
        a2 = fmaf(r4.z, st[c + 2], a2);
        a3 = fmaf(r4.w, st[c + 3], a3);
        st[c] = fmaf(w4.x, st[c], k4.x * vj);
        st[c + 1] = fmaf(w4.y, st[c + 1], k4.y * vj);
        st[c + 2] = fmaf(w4.z, st[c + 2], k4.z * vj);
        st[c + 3] = fmaf(w4.w, st[c + 3], k4.w * vj);
      }
      const float out = fmaf(bonus[t], vj, (a0 + a1) + (a2 + a3));
      o[base + (size_t)(t0 + t) * step] = from_f<TI>(out);
    }
    __syncthreads();                 // the next pass overwrites the stage
  }

  float* sf = s_fin + (size_t)bh * N * N;
#pragma unroll
  for (int c = 0; c < N; ++c) sf[(size_t)c * N + j] = st[c];
}

template <typename TI, int N>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* s0, void* o, void* s_fin, int B, int S,
           int H, cudaStream_t stream) {
  wkv6_kernel<TI, N><<<B * H, N, 0, stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<TI*>(o), static_cast<float*>(s_fin), S, H);
  return (int)cudaGetLastError();
}

template <typename TI>
int dispatch_n(int N, const void* r, const void* k, const void* v,
               const void* lw, const void* u, const void* s0, void* o,
               void* s_fin, int B, int S, int H, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<TI, 16>(r, k, v, lw, u, s0, o, s_fin, B, S, H, stream);
    case 32:
      return launch<TI, 32>(r, k, v, lw, u, s0, o, s_fin, B, S, H, stream);
    case 64:
      return launch<TI, 64>(r, k, v, lw, u, s0, o, s_fin, B, S, H, stream);
    default:
      return -1;
  }
}

}  // namespace

// dt: 0 = fp32, 1 = bf16 (r, k, v and o).  Returns 0 when launched.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* lw, const void* u, const void* s0,
                        void* o, void* s_fin, int dt, int B, int S, int H,
                        int N, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H > 0x7fffffffLL)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt == 0)
    return dispatch_n<float>(N, r, k, v, lw, u, s0, o, s_fin, B, S, H, st);
  if (dt == 1)
    return dispatch_n<__nv_bfloat16>(N, r, k, v, lw, u, s0, o, s_fin, B, S,
                                     H, st);
  return -1;
}
