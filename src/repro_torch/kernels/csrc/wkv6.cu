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
// (bf16) once, 126 MB, and the recurrence does 5 f32 flops per (t, i, j),
// 3.4 GFLOP on the CUDA cores.
//
// Design: a scan over T whose every step rounds the same way wherever a
// call starts or ends, so that one call over T steps returns, bit for
// bit, what T chained one-step calls (a decode) return. A model in bf16
// turns one output rounded the other way into several percent of its
// logits, so a forward and the decode of the same tokens agree only if
// their WKV6 does. The output is computed as
//
//   o_t[j] = sum_i r_t[i] S[i][j] + v_t[j] beta_t,
//   beta_t = sum_i r_t[i] u[i] k_t[i],
//
// with S the state before step t. Column j of the state depends on
// v[:, j] alone, so a CTA takes kVs = 32 columns of one head: B*H x V/32
// CTAs, 80 at the rwkv6-3b prefill shape. In a CTA of 512 threads,
// thread (q, j) holds rows 4q..4q+3 of column j in registers. Per step it
// adds its rows' share of r_t S into a partial sum and updates
// S = exp(w_t) S + k_t v_t: the only dependence from one step to the next
// is one FMA per state element, and no thread waits for another within a
// chunk of kL = 32 steps. A chunk runs in three phases between barriers:
//   1. its inputs, copied to shared memory during the previous chunk, are
//      converted to f32 (w to exp(w)), and beta_t is summed;
//   2. the next chunk's inputs are put in flight (cp.async, 16 bytes a
//      copy, where the layout allows it) and the 32 steps run;
//   3. the 16 row groups' partial sums of each step are added in a fixed
//      order, with the bonus term, and o is written.
// Every product and sum is an explicit round-to-nearest intrinsic, so the
// compiler cannot contract or reorder one differently in another copy of
// the loop. All math is f32 on the CUDA cores, as the plain version:
// tensor-core TF32 or bf16 would break the state's tolerance.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMax = 64;              // K, V <= 64
constexpr int kVs = 32;               // state columns per CTA
constexpr int kQ = 16;                // row groups: threads per column
constexpr int kR = kMax / kQ;         // state rows per thread
constexpr int kL = 32;                // steps per chunk
constexpr int kThreads = kVs * kQ;
constexpr int kWarps = kThreads / 32;
constexpr int kPitch = kMax * 4;      // bytes of a copied input row
static_assert(kR == 4 && kL % kWarps == 0 && (kL * kVs) % kThreads == 0 &&
                  kMax == 64,
              "tile shape");

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
  int r_vec, k_vec, v_vec, w_vec;  // rows 16-byte aligned: cp.async copies
};

struct Smem {
  uint8_t raw_r[kL][kPitch];   // the next chunk's inputs as stored
  uint8_t raw_k[kL][kPitch];
  uint8_t raw_w[kL][kPitch];
  uint8_t raw_v[kL][kVs * 4];  // this CTA's columns
  // the chunk in f32; rows i >= K and steps past T are r = k = v = 0 and
  // exp(w) = 1
  float r[kL][kMax];
  float k[kL][kMax];
  float d[kL][kMax];           // exp(w)
  float v[kL][kVs];
  float part[kL][kVs][kQ + 1]; // per step: each row group's share of r S
                               // (padded: a warp's reads in phase 3
                               // fall on distinct banks)
  float beta[kL];              // per step: r . u . k
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Rows t0..t0+n-1, columns c0..c0+cols-1 of one input (es bytes an
// element, row stride st elements, from element `base`) to rows of
// `pitch` bytes at dst: 16-byte asynchronous copies where `vec`, else
// element by element.
__device__ __forceinline__ void copy_rows(uint8_t* dst, int pitch,
                                          const void* src, long long base,
                                          long long st, int es, int t0,
                                          int n, int c0, int cols, int vec) {
  const char* s = static_cast<const char*>(src);
  if (vec) {
    const int segs = cols * es / 16;
    for (int x = threadIdx.x; x < n * segs; x += kThreads) {
      const int t = x / segs, g = x - t * segs;
      cp_async16(dst + t * pitch + g * 16,
                 s + (base + (t0 + t) * st + c0) * es + g * 16);
    }
  } else {
    for (int x = threadIdx.x; x < n * cols; x += kThreads) {
      const int t = x / cols, c = x - t * cols;
      const long long e = base + (t0 + t) * st + c0 + c;
      if (es == 2)
        reinterpret_cast<uint16_t*>(dst + t * pitch)[c] =
            __ldg(reinterpret_cast<const uint16_t*>(s) + e);
      else
        reinterpret_cast<uint32_t*>(dst + t * pitch)[c] =
            __ldg(reinterpret_cast<const uint32_t*>(s) + e);
    }
  }
}

// element i of a copied row, as f32
__device__ __forceinline__ float raw_at(const uint8_t* row, int i, int bf16) {
  return bf16 ? __uint_as_float(static_cast<uint32_t>(
                    reinterpret_cast<const uint16_t*>(row)[i]) << 16)
              : reinterpret_cast<const float*>(row)[i];
}

// Grid (B*H, ceil(V / kVs)), kThreads threads, sizeof(Smem) bytes.
__global__ void __launch_bounds__(kThreads) wkv6_scan_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j = tid % kVs, q = tid / kVs;  // column in the slice, row group
  const int c0 = blockIdx.y * kVs;         // the slice's first column
  const int cols = min(kVs, a.V - c0);
  const int i0 = q * kR;
  const long long state = static_cast<long long>(bh) * a.K * a.V;

  float S[kR];
#pragma unroll
  for (int m = 0; m < kR; ++m)
    S[m] = (a.s0 != nullptr && i0 + m < a.K && j < cols)
               ? a.s0[state + static_cast<long long>(i0 + m) * a.V + c0 + j]
               : 0.f;
  // u of the rows lane and lane + 32, which this lane sums in beta
  const float u0 = lane < a.K ? a.u[h * a.K + lane] : 0.f;
  const float u1 = lane + 32 < a.K ? a.u[h * a.K + lane + 32] : 0.f;

  const long long rb = b * a.sr[0] + h * a.sr[1];
  const long long kb = b * a.sk[0] + h * a.sk[1];
  const long long vb = b * a.sv[0] + h * a.sv[1];
  const long long wb = b * a.sw[0] + h * a.sw[1];
  const long long ob = static_cast<long long>(bh) * a.T * a.V;

  auto copy_chunk = [&](int t0) {
    const int n = min(kL, a.T - t0);
    copy_rows(&sm.raw_r[0][0], kPitch, a.r, rb, a.sr[2], a.r_bf16 ? 2 : 4,
              t0, n, 0, a.K, a.r_vec);
    copy_rows(&sm.raw_k[0][0], kPitch, a.k, kb, a.sk[2], a.k_bf16 ? 2 : 4,
              t0, n, 0, a.K, a.k_vec);
    copy_rows(&sm.raw_w[0][0], kPitch, a.w, wb, a.sw[2], a.w_bf16 ? 2 : 4,
              t0, n, 0, a.K, a.w_vec);
    copy_rows(&sm.raw_v[0][0], kVs * 4, a.v, vb, a.sv[2], a.v_bf16 ? 2 : 4,
              t0, n, c0, cols, a.v_vec);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  copy_chunk(0);
  for (int t0 = 0; t0 < a.T; t0 += kL) {
    const int n = min(kL, a.T - t0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // the chunk is copied; the previous one's o written

    // 1. to f32: warp w takes steps w, w + kWarps, ...; lane l rows l and
    // l + 32, whose r u k it sums into beta by a butterfly over the lanes
    // (every lane ends with the same sum: each addition is commutative)
#pragma unroll
    for (int x = 0; x < kL / kWarps; ++x) {
      const int tt = warp + x * kWarps;
      float rr[2], kk[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = lane + 32 * e;
        const bool in = tt < n && i < a.K;
        rr[e] = in ? raw_at(sm.raw_r[tt], i, a.r_bf16) : 0.f;
        kk[e] = in ? raw_at(sm.raw_k[tt], i, a.k_bf16) : 0.f;
        sm.r[tt][i] = rr[e];
        sm.k[tt][i] = kk[e];
        sm.d[tt][i] = in ? expf(raw_at(sm.raw_w[tt], i, a.w_bf16)) : 1.f;
      }
      float s = __fmul_rn(__fmul_rn(rr[0], u0), kk[0]);
      s = __fmaf_rn(__fmul_rn(rr[1], u1), kk[1], s);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, m));
      if (lane == 0) sm.beta[tt] = s;
    }
#pragma unroll
    for (int m = 0; m < kL * kVs / kThreads; ++m) {
      const int idx = tid + m * kThreads;
      const int tt = idx / kVs, c = idx % kVs;
      sm.v[tt][c] = (tt < n && c < cols) ? raw_at(sm.raw_v[tt], c, a.v_bf16)
                                         : 0.f;
    }
    __syncthreads();

    // 2. the next chunk in flight; the steps: this thread's rows of r S
    // (before the step), then S
    if (t0 + kL < a.T) copy_chunk(t0 + kL);
#pragma unroll 8
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sm.v[tt][j];
      const float4 r4 = ld4(&sm.r[tt][i0]);
      const float4 k4 = ld4(&sm.k[tt][i0]);
      const float4 d4 = ld4(&sm.d[tt][i0]);
      const float rr[kR] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[kR] = {k4.x, k4.y, k4.z, k4.w};
      const float dd[kR] = {d4.x, d4.y, d4.z, d4.w};
      float p = __fmul_rn(rr[0], S[0]);
#pragma unroll
      for (int m = 1; m < kR; ++m) p = __fmaf_rn(rr[m], S[m], p);
#pragma unroll
      for (int m = 0; m < kR; ++m)
        S[m] = __fmaf_rn(dd[m], S[m], __fmul_rn(kk[m], vj));
      sm.part[tt][j][q] = p;
    }
    __syncthreads();

    // 3. the chunk's outputs, each step's row groups added in order
#pragma unroll
    for (int m = 0; m < kL * kVs / kThreads; ++m) {
      const int idx = tid + m * kThreads;
      const int tt = idx / kVs, c = idx % kVs;
      if (tt < n && c < cols) {
        float acc = sm.part[tt][c][0];
#pragma unroll
        for (int g = 1; g < kQ; ++g) acc = __fadd_rn(acc, sm.part[tt][c][g]);
        const float o = __fmaf_rn(sm.v[tt][c], sm.beta[tt], acc);
        const long long oi =
            ob + static_cast<long long>(t0 + tt) * a.V + c0 + c;
        if (a.r_bf16)
          static_cast<__nv_bfloat16*>(a.o)[oi] = __float2bfloat16_rn(o);
        else
          static_cast<float*>(a.o)[oi] = o;
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (j < cols) {
#pragma unroll
    for (int m = 0; m < kR; ++m)
      if (i0 + m < a.K)
        a.sf[state + static_cast<long long>(i0 + m) * a.V + c0 + j] = S[m];
  }
}

// Whether every row of an input (n0 x n1 x n2 rows of `cols` elements of
// es bytes, strides s0, s1, s2) starts 16-byte aligned and spans whole
// 16-byte segments; a dimension of size 1 takes no stride.
int rows_aligned(const void* p, int n0, int n1, int n2, long long s0,
                 long long s1, long long s2, int cols, int es) {
  auto ok = [](int n, long long s, int es) {
    return n == 1 || (s * es) % 16 == 0;
  };
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ok(n0, s0, es) &&
         ok(n1, s1, es) && ok(n2, s2, es) && (cols * es) % 16 == 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and
// returns a CUDA error code (0 = launched). B*H must be positive, T >= 0,
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
  const auto es = [](int bf16) { return bf16 ? 2 : 4; };
  Args a{r, k, v, w, u, s0, o, sf, H, T, K, V,
         {srb, srh, srt}, {skb, skh, skt}, {svb, svh, svt},
         {swb, swh, swt}, r_bf16, k_bf16, v_bf16, w_bf16,
         rows_aligned(r, B, H, T, srb, srh, srt, K, es(r_bf16)),
         rows_aligned(k, B, H, T, skb, skh, skt, K, es(k_bf16)),
         rows_aligned(v, B, H, T, svb, svh, svt, V, es(v_bf16)),
         rows_aligned(w, B, H, T, swb, swh, swt, K, es(w_bf16))};
  const int bytes = sizeof(Smem);
  // the shared-memory limit is raised once per device (a decode step
  // launches this kernel per layer and token)
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(wkv6_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < 64) raised[dev] = true;
  }
  const dim3 grid(B * H, (V + kVs - 1) / kVs);
  wkv6_scan_kernel<<<grid, kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
