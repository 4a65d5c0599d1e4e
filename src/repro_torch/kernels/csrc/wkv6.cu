// RWKV6 (Finch) WKV recurrence for Hopper, with data-dependent decay:
//
//   o_t = r_t (S + diag(u) k_t^T v_t)
//   S  <- diag(exp(w_t)) S + k_t^T v_t        (w <= 0, all math in f32)
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py::_wkv6_kernel.
// The contract and the plain PyTorch version it is held against are in
// src/repro_torch/kernels/wkv6.py.
//
// Bound: operations. At the rwkv6-3b prefill shape (B=1, H=40, T=4096,
// K=V=64) a launch reads r, k, v (bf16) and w (f32) once and writes o
// (bf16) once, 126 MB, and does 7 f32 flops per (t, i, j), 4.7 GFLOP on
// the CUDA cores. In practice the sequential walk over T bounds it: only
// B*H CTAs run.
//
// Design (simple first): one CTA of 256 threads per (b, h). The state's
// columns evolve independently, so thread (j, q) owns rows 16q..16q+15
// of column S[:, j] in registers (rows i >= K stay zero); the four
// threads of a column are neighbouring lanes and add their parts of
// o_t[j] with two shuffles. The CTA walks T in chunks of kL steps staged
// in shared memory: r, k, exp(w) (rows padded to 64 with 0, 0 and 1),
// v and u, with the row groups padded so that the float4 reads of a
// warp hit distinct banks. The next chunk's loads are issued into
// registers before the current chunk's steps run, so their latency
// hides behind the steps; exp(w) is taken once per (t, i) while
// staging. The TPU kernel's chunked matrix form (an answer to the MXU)
// is not carried over: the result does not depend on a chunk length.
// T = 1 (one decode step) takes the same path.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMax = 64;                   // K, V <= 64
constexpr int kQ = 4;                      // threads per state column
constexpr int kR = kMax / kQ;              // rows per thread
constexpr int kPad = kR + 4;               // padded row group
constexpr int kL = 32;                     // time steps staged per chunk
constexpr int kThreads = kMax * kQ;        // 256
constexpr int kStage = kL * kMax / kThreads;  // (t, i) staged per thread

__device__ __forceinline__ float load_f(const void* p, long long i,
                                        int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;   // (H, K)
  const float* s0;  // (B, H, K, V) or null for zeros
  void* o;          // (B, H, T, V), contiguous, r's dtype
  float* sf;        // (B, H, K, V), contiguous
  int H, T, K, V;
  long long sr[3], sk[3], sv[3], sw[3];  // strides of (b, h, t); unit last
  int r_bf16, k_bf16, v_bf16, w_bf16;
};

__global__ void __launch_bounds__(kThreads) wkv6_kernel(Args a) {
  __shared__ __align__(16) float rs[kL][kQ][kPad];
  __shared__ __align__(16) float ks[kL][kQ][kPad];
  __shared__ __align__(16) float ds[kL][kQ][kPad];  // exp(w)
  __shared__ float vs[kL][kMax];
  __shared__ __align__(16) float us[kQ][kPad];

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x;
  const int j = tid / kQ, q = tid % kQ;  // column, row group
  const int i0 = q * kR;
  const long long state = static_cast<long long>(bh) * a.K * a.V;

  float S[kR];
#pragma unroll
  for (int m = 0; m < kR; ++m)
    S[m] = (a.s0 != nullptr && i0 + m < a.K && j < a.V)
               ? a.s0[state + static_cast<long long>(i0 + m) * a.V + j]
               : 0.f;
  if (tid < kMax) us[tid / kR][tid % kR] = tid < a.K ? a.u[h * a.K + tid] : 0.f;

  const long long rb = b * a.sr[0] + h * a.sr[1];
  const long long kb = b * a.sk[0] + h * a.sk[1];
  const long long vb = b * a.sv[0] + h * a.sv[1];
  const long long wb = b * a.sw[0] + h * a.sw[1];
  const bool o_bf16 = a.r_bf16 != 0;
  const long long ob = static_cast<long long>(bh) * a.T * a.V;

  // entry m of this thread's share of a chunk: step idx / kMax, row or
  // column idx % kMax, idx = tid + m * kThreads
  float pr[kStage], pk[kStage], pw[kStage], pv[kStage];
  auto load = [&](int t0) {
#pragma unroll
    for (int m = 0; m < kStage; ++m) {
      const int idx = tid + m * kThreads;
      const int i = idx % kMax;
      const long long t = t0 + idx / kMax;
      const bool in_t = t < a.T;
      const bool in_k = in_t && i < a.K;
      pr[m] = in_k ? load_f(a.r, rb + t * a.sr[2] + i, a.r_bf16) : 0.f;
      pk[m] = in_k ? load_f(a.k, kb + t * a.sk[2] + i, a.k_bf16) : 0.f;
      pw[m] = in_k ? load_f(a.w, wb + t * a.sw[2] + i, a.w_bf16) : 0.f;
      pv[m] = (in_t && i < a.V) ? load_f(a.v, vb + t * a.sv[2] + i, a.v_bf16)
                                : 0.f;
    }
  };

  load(0);
  for (int t0 = 0; t0 < a.T; t0 += kL) {
    const int n = min(kL, a.T - t0);
    __syncthreads();  // the previous chunk is consumed (and us is set)
#pragma unroll
    for (int m = 0; m < kStage; ++m) {
      const int idx = tid + m * kThreads;
      const int tt = idx / kMax, i = idx % kMax;
      rs[tt][i / kR][i % kR] = pr[m];
      ks[tt][i / kR][i % kR] = pk[m];
      ds[tt][i / kR][i % kR] = expf(pw[m]);  // padded rows: exp(0) = 1
      vs[tt][i] = pv[m];
    }
    __syncthreads();
    if (t0 + kL < a.T) load(t0 + kL);  // in flight during the steps below
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float o = 0.f;
#pragma unroll
      for (int m4 = 0; m4 < kR; m4 += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[tt][q][m4]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[tt][q][m4]);
        const float4 d4 = *reinterpret_cast<const float4*>(&ds[tt][q][m4]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[q][m4]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = kk[c] * vj;
          o = fmaf(rr[c], fmaf(uu[c], kv, S[m4 + c]), o);
          S[m4 + c] = fmaf(dd[c], S[m4 + c], kv);
        }
      }
      // the kQ threads of a column are lanes differing in their low bits
      o += __shfl_xor_sync(0xffffffffu, o, 1);
      o += __shfl_xor_sync(0xffffffffu, o, 2);
      if (q == 0 && j < a.V) {
        const long long oi = ob + static_cast<long long>(t0 + tt) * a.V + j;
        if (o_bf16)
          static_cast<__nv_bfloat16*>(a.o)[oi] = __float2bfloat16(o);
        else
          static_cast<float*>(a.o)[oi] = o;
      }
    }
  }
  if (j < a.V) {
#pragma unroll
    for (int m = 0; m < kR; ++m)
      if (i0 + m < a.K)
        a.sf[state + static_cast<long long>(i0 + m) * a.V + j] = S[m];
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and
// returns cudaGetLastError() (0 = launched). B*H and T must be positive,
// K and V in [1, 64]. Each *_bf16 flag selects __nv_bfloat16 for that
// input (else float); o takes r's type.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const float* u, const float* s0,
                           void* o, float* sf, int B, int H, int T, int K,
                           int V, long long srb, long long srh,
                           long long srt, long long skb, long long skh,
                           long long skt, long long svb, long long svh,
                           long long svt, long long swb, long long swh,
                           long long swt, int r_bf16, int k_bf16,
                           int v_bf16, int w_bf16, void* stream) {
  Args a{r, k, v, w, u, s0, o, sf, H, T, K, V,
         {srb, srh, srt}, {skb, skh, skt}, {svb, svh, svt},
         {swb, swh, swt}, r_bf16, k_bf16, v_bf16, w_bf16};
  wkv6_kernel<<<B * H, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
