// RWKV6 WKV backward for Hopper, sm_90a.
//
// Replaces no Pallas kernel: the reference trains RWKV6 by jax.grad through
// the plain jnp src/repro/models/rwkv.py:wkv6_chunked (45).  This is that
// gradient, for the forward kernel csrc/rwkv6_wkv.cu, called through
// kernels/ops.py:wkv6_bwd from the backward of ops.WKV6 (every RWKV layer of
// every training step).
//
// What it computes, per (batch b, head h), with w_t = exp(lw_t), S_t the
// state after step t (S_{-1} = s0) and dS_t the gradient of S_t, walking
// the steps in reverse from dS_{S-1} = ds_fin:
//   dr_t  = (S_{t-1} + u k_t v_t^T) do_t
//   dk_t  = dS_t v_t + u r_t (do_t . v_t)
//   dv_t  = dS_t^T k_t + (r_t . (u (*) k_t)) do_t
//   dlw_t = w_t (*) rowsum(dS_t (*) S_{t-1})
//   du   += r_t (*) k_t (do_t . v_t)
//   dS_{t-1} = diag(w_t) dS_t + r_t do_t^T,      ds0 = dS_{-1}
// r, k, v, do (B, S, H, N) in fp32 or bf16; lw (B, S, H, N) fp32; u (H, N)
// fp32; ckpt (B, H, ceil(S / seg), N, N) fp32, the states the forward wrote
// before every seg-th step; ds_fin (B, H, N, N) fp32 or null (zero).  Out:
// dr, dk, dv in the inputs' dtype, rounded once; dlw fp32; du per (b, h)
// (B, H, N) fp32, which the wrapper sums over b; ds0 (B, H, N, N) fp32.
// All arithmetic is fp32.
//
// Design: the step recurrence, simple and right first.  Every element of
// S and dS evolves on its own (the decay is diagonal); the steps couple
// only through the sums of the outputs: over the value columns for dr, dk
// and dlw, over the channels (rows) for dv.  A block owns one (b, h):
// N / 8 warps, a warp 8 value columns, a lane the rows c = lane + 32 i, so
// a thread holds (N / 32) x 8 elements of dS in registers (16 at N 64)
// and dv's sum over the rows is a warp shuffle; dr, dk and dlw are summed
// per warp in registers and over the warps in shared memory, in a fixed
// order (no atomics: two calls are bit-equal).  Segments are walked in
// reverse; a segment's inputs are staged in shared memory as fp32 (w as
// exp(lw)), then each sub-segment of 8 steps, last first, rebuilds its
// states S_{t-1} from the segment's checkpoint by the step recurrence in
// fp32 (1.5x the steps at seg 16) into shared memory, each thread its own
// elements, and walks its steps in reverse with dS in registers.
//
// Bound on the card: the bytes (r, k, v, do read and dr, dk, dv written in
// the inputs' dtype, lw read and dlw written in fp32, s0, ds_fin and ds0)
// once each, 0.74 GB at B 2, S 4096, H 64, N 64 in bf16, 0.22 ms at 3.35
// TB/s; a chunked tensor-core form needs fewer operations than that
// (chip_smoke.py:wkv_bwd_work).  This kernel does the step recurrence's
// 14 N^2 fp32 operations a step and head and reads each state twice from
// shared memory, with one block (8 warps at N 64) an SM on 128 of 132 SMs:
// held by instruction issue, latency and shared-memory bandwidth, it takes
// 3.74 ms at that shape, 17x the bound (chip_smoke.py on an H100 SXM).  The
// chunked tensor-core form of the forward is its redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB = 8;    // steps whose states a block holds at once
constexpr int CPW = 8;    // value columns a warp
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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
// a[l % M] (M a power of two <= 32).
template <int M>
__device__ __forceinline__ float reduce_scatter(float (&a)[M], int lane) {
  halve<M / 2, M>(a, lane);
#pragma unroll
  for (int off = M; off < 32; off <<= 1)
    a[0] += __shfl_xor_sync(0xffffffffu, a[0], off);
  return a[0];
}

template <int N>
struct Shape {
  static constexpr int NW = N / CPW;                  // warps
  static constexpr int NT = 32 * NW;                  // threads
  static constexpr int RPT = N >= 32 ? N / 32 : 1;    // rows a lane
  static constexpr int E = RPT * CPW;                 // elements a thread
  // shared memory in floats: the rebuilt states [SUB][E][NT], the per-warp
  // row sums [3][SUB][NW][N] (dr, dk, dlw), then the segment's inputs
  // [5][seg][N] (r, k, v, do, w)
  static constexpr int ST = 0;
  static constexpr int RP = ST + SUB * E * NT;
  static constexpr int TILES = RP + 3 * SUB * NW * N;
  static constexpr int bytes(int seg) { return 4 * (TILES + 5 * seg * N); }
};

template <typename TI, int N>
__global__ void __launch_bounds__(Shape<N>::NT, 1)
wkv6_bwd_walk(const TI* __restrict__ r, const TI* __restrict__ k,
              const TI* __restrict__ v, const float* __restrict__ lw,
              const float* __restrict__ u, const float* __restrict__ ckpt,
              const TI* __restrict__ dout, const float* __restrict__ ds_fin,
              TI* __restrict__ dr, TI* __restrict__ dk, TI* __restrict__ dv,
              float* __restrict__ dlw, float* __restrict__ du_part,
              float* __restrict__ ds0, int S, int H, int seg) {
  using SH = Shape<N>;
  constexpr int NW = SH::NW, NT = SH::NT, RPT = SH::RPT, E = SH::E;
  extern __shared__ float sm[];
  float* st = sm + SH::ST;
  float* rp = sm + SH::RP;
  float* tr = sm + SH::TILES;
  float* tk = tr + seg * N;
  float* tv = tk + seg * N;
  float* tdo = tv + seg * N;
  float* tw = tdo + seg * N;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int v0 = CPW * warp;
  const size_t step = (size_t)H * N;
  const size_t base = (size_t)b * S * step + (size_t)h * N;  // (b, 0, h, 0)
  const int nseg = (S + seg - 1) / seg;

  int row[RPT];
  bool ok[RPT];
  float uu[RPT], du[RPT];
  float ds[RPT][CPW];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    row[i] = lane + 32 * i;
    ok[i] = row[i] < N;           // at N 16 half the lanes hold no row
    uu[i] = ok[i] ? u[h * N + row[i]] : 0.f;
    du[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPW; ++j)
      ds[i][j] = ok[i] && ds_fin != nullptr
                     ? ds_fin[((size_t)bh * N + row[i]) * N + v0 + j]
                     : 0.f;
  }

  for (int sg = nseg - 1; sg >= 0; --sg) {
    const int t0 = sg * seg, n = min(seg, S - t0);
    __syncthreads();      // the previous segment's inputs are read
    for (int e = tid; e < n * N; e += NT) {
      const int t = e / N, c = e - t * N;
      const size_t gi = base + (size_t)(t0 + t) * step + c;
      tr[e] = to_f(r[gi]);
      tk[e] = to_f(k[gi]);
      tv[e] = to_f(v[gi]);
      tdo[e] = to_f(dout[gi]);
      tw[e] = expf(lw[gi]);
    }
    __syncthreads();
    const float* cp = ckpt + ((size_t)bh * nseg + sg) * N * N;
    for (int a = (n - 1) / SUB * SUB; a >= 0; a -= SUB) {
      const int m = min(SUB, n - a);
      // rebuild S_{t-1} for the steps t0 + a .. t0 + a + m - 1, each thread
      // its own elements, from the segment's checkpoint
      float s[RPT][CPW];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPW; ++j)
          s[i][j] = ok[i] ? cp[(size_t)row[i] * N + v0 + j] : 0.f;
      for (int t = 0; t < a + m - 1; ++t) {
        if (t >= a) {
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPW; ++j)
              st[((t - a) * E + i * CPW + j) * NT + tid] = s[i][j];
        }
        float vv[CPW];
#pragma unroll
        for (int j = 0; j < CPW; ++j) vv[j] = tv[t * N + v0 + j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float ww = ok[i] ? tw[t * N + row[i]] : 0.f;
          const float kk = ok[i] ? tk[t * N + row[i]] : 0.f;
#pragma unroll
          for (int j = 0; j < CPW; ++j) s[i][j] = fmaf(ww, s[i][j], kk * vv[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPW; ++j)
          st[((m - 1) * E + i * CPW + j) * NT + tid] = s[i][j];

      // walk the sub-segment's steps in reverse
      for (int sl = m - 1; sl >= 0; --sl) {
        const int t = a + sl;
        float vv[CPW], dd[CPW], pv[CPW];
        float dov = 0.f;
#pragma unroll
        for (int j = 0; j < CPW; ++j) {
          vv[j] = tv[t * N + v0 + j];
          dd[j] = tdo[t * N + v0 + j];
          dov = fmaf(dd[j], vv[j], dov);     // this warp's columns
        }
        float rr[RPT], kk[RPT], ww[RPT], ruk = 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          rr[i] = ok[i] ? tr[t * N + row[i]] : 0.f;
          kk[i] = ok[i] ? tk[t * N + row[i]] : 0.f;
          ww[i] = ok[i] ? tw[t * N + row[i]] : 0.f;
          ruk = fmaf(rr[i] * uu[i], kk[i], ruk);
        }
#pragma unroll
        for (int j = 0; j < CPW; ++j) pv[j] = ruk * dd[j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          float pr = uu[i] * kk[i] * dov, pk = uu[i] * rr[i] * dov, pl = 0.f;
#pragma unroll
          for (int j = 0; j < CPW; ++j) {
            const float sp = st[(sl * E + i * CPW + j) * NT + tid];
            const float g = ds[i][j];
            pr = fmaf(sp, dd[j], pr);
            pk = fmaf(g, vv[j], pk);
            pl = fmaf(g, sp, pl);
            pv[j] = fmaf(g, kk[i], pv[j]);
            ds[i][j] = fmaf(ww[i], g, rr[i] * dd[j]);
          }
          du[i] = fmaf(rr[i] * kk[i], dov, du[i]);
          if (ok[i]) {
            rp[((0 * SUB + sl) * NW + warp) * N + row[i]] = pr;
            rp[((1 * SUB + sl) * NW + warp) * N + row[i]] = pk;
            rp[((2 * SUB + sl) * NW + warp) * N + row[i]] = pl;
          }
        }
        // dv: the sum over the rows, which the warp's lanes hold
        const float x = reduce_scatter<CPW>(pv, lane);
        if (lane < CPW) store(&dv[base + (size_t)(t0 + t) * step + v0 + lane], x);
      }
      __syncthreads();
      // dr, dk and dlw of the sub-segment: the warps' sums, in warp order
      for (int e = tid; e < 3 * m * N; e += NT) {
        const int qq = e / (m * N), rem = e - qq * m * N;
        const int sl = rem / N, c = rem - sl * N;
        float x = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) x += rp[((qq * SUB + sl) * NW + w) * N + c];
        const int t = a + sl;
        const size_t gi = base + (size_t)(t0 + t) * step + c;
        if (qq == 0)
          store(&dr[gi], x);
        else if (qq == 1)
          store(&dk[gi], x);
        else
          dlw[gi] = tw[t * N + c] * x;
      }
      __syncthreads();    // rp is written again by the next sub-segment
    }
  }

  float* d0 = ds0 + (size_t)bh * N * N;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (ok[i]) {
#pragma unroll
      for (int j = 0; j < CPW; ++j) d0[(size_t)row[i] * N + v0 + j] = ds[i][j];
      rp[warp * N + row[i]] = du[i];
    }
  }
  __syncthreads();
  for (int c = tid; c < N; c += NT) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) x += rp[w * N + c];
    du_part[(size_t)bh * N + c] = x;
  }
}

template <typename TI, int N>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* ckpt, const void* dout,
           const void* ds_fin, void* dr, void* dk, void* dv, void* dlw,
           void* du_part, void* ds0, int B, int S, int H, int seg,
           cudaStream_t stream) {
  using SH = Shape<N>;
  const int smem = SH::bytes(seg);
  if (smem > SMEM_MAX) return -1;
  // once per instantiation and device
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return -1;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(wkv6_bwd_walk<TI, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  wkv6_bwd_walk<TI, N><<<B * H, SH::NT, smem, stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(ckpt),
      static_cast<const TI*>(dout), static_cast<const float*>(ds_fin),
      static_cast<TI*>(dr), static_cast<TI*>(dk), static_cast<TI*>(dv),
      static_cast<float*>(dlw), static_cast<float*>(du_part),
      static_cast<float*>(ds0), S, H, seg);
  return (int)cudaGetLastError();
}

template <typename TI>
int dispatch_n(int N, const void* r, const void* k, const void* v,
               const void* lw, const void* u, const void* ckpt,
               const void* dout, const void* ds_fin, void* dr, void* dk,
               void* dv, void* dlw, void* du_part, void* ds0, int B, int S,
               int H, int seg, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<TI, 16>(r, k, v, lw, u, ckpt, dout, ds_fin, dr, dk, dv,
                            dlw, du_part, ds0, B, S, H, seg, stream);
    case 32:
      return launch<TI, 32>(r, k, v, lw, u, ckpt, dout, ds_fin, dr, dk, dv,
                            dlw, du_part, ds0, B, S, H, seg, stream);
    case 64:
      return launch<TI, 64>(r, k, v, lw, u, ckpt, dout, ds_fin, dr, dk, dv,
                            dlw, du_part, ds0, B, S, H, seg, stream);
    default:
      return -1;
  }
}

}  // namespace

// dt: 0 = fp32, 1 = bf16 (r, k, v, do and dr, dk, dv).  All operands
// contiguous; ds_fin may be null (a zero gradient); seg a positive multiple
// of the forward's chunk (8) whose staged inputs fit the shared memory.
// Returns 0 when launched, a CUDA error code when the launch was refused,
// -1 for an unsupported shape, type or segment.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* lw, const void* u, const void* ckpt,
                        const void* dout, const void* ds_fin, void* dr,
                        void* dk, void* dv, void* dlw, void* du_part,
                        void* ds0, int dt, int B, int S, int H, int N, int seg,
                        void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H > 0x7fffffffLL)
    return -1;
  if (seg <= 0 || seg % 8 != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt == 0)
    return dispatch_n<float>(N, r, k, v, lw, u, ckpt, dout, ds_fin, dr, dk,
                             dv, dlw, du_part, ds0, B, S, H, seg, st);
  if (dt == 1)
    return dispatch_n<__nv_bfloat16>(N, r, k, v, lw, u, ckpt, dout, ds_fin,
                                     dr, dk, dv, dlw, du_part, ds0, B, S, H,
                                     seg, st);
  return -1;
}
