// Blocked online-softmax attention for Hopper: q (B,Hq,Tq,D) against
// k/v (B,Hkv,Tk,D), GQA, end-aligned causal mask, sliding window and a
// per-batch valid KV length.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_attn_kernel. The contract and
// the plain PyTorch version it is held against are in
// src/repro_torch/kernels/flash_attention.py.
//
// Bound: operations. At the qwen3-0.6b prefill shape (Hq=16, Hkv=8,
// T=4096, D=128, causal) one launch does 4*D flops on each of 134M
// visible (query, key) pairs, 69 GFLOP, against 50 MB of q/k/v/o.
//
// Design (simple first): every product and sum is f32, as in the TPU
// kernel, so the math runs on the CUDA cores, not the tensor cores. One
// CTA of 256 threads per (query tile of 64 rows, head, batch); it walks
// the KV axis in tiles of 64 keys, skipping tiles that its rows cannot
// see. Q (pre-scaled by D^-0.5) and each K tile sit transposed in shared
// memory, so a thread's 4x4 block of logits is an outer-product loop
// over d with float4 loads; the V tile sits row-major for the P@V
// product, whose P goes through shared memory. The online-softmax row
// state (m, l) lives in registers of the 16 threads that share a row
// and is reduced with warp shuffles. Query tiles are scheduled last
// tile first, so the causal mask's heaviest tiles start first. Any Tq
// and Tk work: tails are zero-filled and masked.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 64;       // keys per KV tile
constexpr int kThreads = 256;
constexpr int kLQ = kBQ + 4;  // padded row length of transposed Q
constexpr int kLK = kBK + 4;  // ... of transposed K and of P
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p,
                                        long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i,
                                        float x) {
  p[i] = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* kv_len;  // (B,) or null for Tk
  void* o;                // (B, Hq, Tq, D), contiguous
  int Hq, Hkv, Tq, Tk;
  long long sq[3], sk[3], sv[3];  // strides of (b, h, t); d is unit
  int causal, window;             // window <= 0: none
  float scale;
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) attn_kernel(Args a) {
  constexpr int DV = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;             // [D][kLQ]
  float* Kt = Qt + D * kLQ;     // [D][kLK]
  float* Vs = Kt + D * kLK;     // [kBK][D]
  float* Ps = Vs + kBK * D;     // [kBQ][kLK]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // logit columns tx*4 .., output columns tx*DV ..
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = iq * kBQ;
  const int off = a.Tk - a.Tq;  // end-aligned: row i sits at i + off
  int kv_end = a.Tk;
  if (a.kv_len != nullptr) kv_end = min(max(a.kv_len[b], 0), a.Tk);

  const T* qp = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1];

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int t = q0 + r;
    Qt[d * kLQ + r] =
        t < a.Tq ? load_f(qp, t * a.sq[2] + d) * a.scale : 0.f;
  }

  float m[4], l[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DV; ++j) acc[i][j] = 0.f;
  }

  // the rows this CTA holds, as key positions
  const int qpos_first = q0 + off;
  const int qpos_last = min(q0 + kBQ, a.Tq) - 1 + off;
  const int n_tiles = (a.Tk + kBK - 1) / kBK;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBK;
    // skip KV tiles no row of this CTA can see (uniform over the CTA)
    bool visible = k0 < kv_end;
    if (a.causal) visible = visible && k0 <= qpos_last;
    if (a.window > 0) visible = visible && k0 + kBK - 1 > qpos_first - a.window;
    if (!visible) continue;

    __syncthreads();  // the previous tile's Kt, Vs and Ps are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      const int t = k0 + c;
      const bool in = t < a.Tk;
      Kt[d * kLK + c] = in ? load_f(kp, t * a.sk[2] + d) : 0.f;
      Vs[c * D + d] = in ? load_f(vp, t * a.sv[2] + d) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * kLQ + ty * 4]);
      const float4 kb = *reinterpret_cast<const float4*>(&Kt[d * kLK + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + off;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        bool v = kpos < kv_end;
        if (a.causal) v = v && kpos <= qpos;
        if (a.window > 0) v = v && kpos > qpos - a.window;
        ok[j] = v;
        s[i][j] = v ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes with equal bit 4
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * kLK + tx * 4 + j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DV; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // Ps complete

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kLK + c];
      float vv[DV];
#pragma unroll
      for (int j = 0; j < DV; ++j) vv[j] = Vs[c * D + tx * DV + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DV; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  T* op = static_cast<T*>(a.o) + (static_cast<long long>(b) * a.Hq + h) *
                                     a.Tq * static_cast<long long>(D);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= a.Tq) continue;
    const float inv = l[i] == 0.f ? 1.f : l[i];  // fully masked row: 0
#pragma unroll
    for (int j = 0; j < DV; ++j)
      store_f(op, static_cast<long long>(t) * D + tx * DV + j,
              acc[i][j] / inv);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (D * kLQ + D * kLK + kBK * D + kBQ * kLK);
}

template <int D, typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.Hq, B);
  attn_kernel<D, T><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32, T>(a, B, stream);
    case 64: return launch<64, T>(a, B, stream);
    case 128: return launch<128, T>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and
// returns the CUDA error code (0 = launched). D must be 32, 64 or 128;
// Tq, Hq must be positive and Hq a multiple of Hkv. bf16 != 0 selects
// __nv_bfloat16 for q, k, v and o, else float.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const int32_t* kv_len,
    void* o, int B, int Hq, int Hkv, int Tq, int Tk, int D,
    long long sqb, long long sqh, long long sqt, long long skb,
    long long skh, long long skt, long long svb, long long svh,
    long long svt, int causal, int window, float scale, int bf16,
    void* stream) {
  Args a{q, k, v, kv_len, o, Hq, Hkv, Tq, Tk,
         {sqb, sqh, sqt}, {skb, skh, skt}, {svb, svh, svt},
         causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_d<__nv_bfloat16>(a, B, D, s)
              : dispatch_d<float>(a, B, D, s);
}
