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
// Two kernels, one per input dtype.
//
// bf16 (every launch of the served models): attn_bf16_kernel, on the
// tensor cores. A CTA holds 64 query rows of NC query heads of one GQA
// group (NC = 2 when the group is even, else 1): warpgroup 0 is the
// producer, whose one thread loads the Q tiles once and then the K/V
// tiles of 64 keys by TMA (128-byte swizzle, tensor maps encoded on the
// host from the tensors' real strides, so the model's transposed views
// need no copy) into a ring of stages, each with a full and an
// empty mbarrier; warpgroups 1..NC are consumers, one query head each,
// over the one K/V ring, so a K/V tile is fetched once per head pair.
// A consumer computes S = Q K^T with wgmma m64n64k16 (both operands in
// shared memory, K-major), scales S by D^-0.5 in f32 after the product,
// masks it in registers (end-aligned causal, window, kv_len; only on
// tiles that cross a mask edge), and runs the online softmax in f32.
// P is then split in registers as p_hi = bf16(p), p_lo = bf16(p - p_hi):
// the S accumulator's layout is the layout of wgmma's register A
// operand, so both halves go straight into two register-A wgmmas
// against the same V tile (V in shared memory, MN-major, the transpose
// bit set), accumulated into one f32 O. One bf16 P would leave ~12% of
// the outputs more than one bf16 step from the f32 function at
// T=4096; with the split P is carried to ~16 bits and the result stays
// within one step (the tests hold an emulation of this arithmetic to
// that). Tiles no row can see are skipped; query tiles run heaviest
// (last) first; tails are zero-filled by TMA and masked. Rows that see
// no key come back as zeros.
//
// Head dims: D is padded to DP, a whole number of 64-column (128-byte)
// TMA boxes: 32 -> 64, 64, 128, 160 -> 192, 256. The tensor maps keep
// D as the row length, so TMA fills the pad with zeros; QK^T stops at
// the last 16 columns that hold data, and the output store masks to D.
// The ring holds 3 stages up to DP = 192 and 2 at DP = 256, so that
// NC = 2 heads of Q and the ring stay within the 227 KB a block may use
// (192 KB at DP = 192 and at DP = 256). The O accumulator is DP / 2
// floats a consumer thread (128 at DP = 256): the producer gives up its
// registers (setmaxnreg) so that the consumers can hold it.
//
// f32 (the route checks): attn_f32_kernel, every product in f32 on the
// CUDA cores, as the TPU kernel. One CTA of 256 threads per (query tile
// of 64 rows, head, batch); Q (pre-scaled) and each K tile transposed
// in shared memory, a thread's 4x4 block of logits an outer-product
// loop over d, V row-major for P@V, the row state in the registers of
// the 16 threads of a row.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;       // query rows per CTA (per consumer)
constexpr int kBK = 64;       // keys per KV tile
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kLQ = kBQ + 4;  // padded row length of transposed Q
constexpr int kLK = kBK + 4;  // ... of transposed K and of P

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

template <int D>
__global__ void __launch_bounds__(kThreads) attn_f32_kernel(Args a) {
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

  const float* qp = static_cast<const float*>(a.q) + b * a.sq[0] +
                    h * a.sq[1];
  const float* kp = static_cast<const float*>(a.k) + b * a.sk[0] +
                    hk * a.sk[1];
  const float* vp = static_cast<const float*>(a.v) + b * a.sv[0] +
                    hk * a.sv[1];

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int t = q0 + r;
    Qt[d * kLQ + r] = t < a.Tq ? qp[t * a.sq[2] + d] * a.scale : 0.f;
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
      Kt[d * kLK + c] = in ? kp[t * a.sk[2] + d] : 0.f;
      Vs[c * D + d] = in ? vp[t * a.sv[2] + d] : 0.f;
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

  float* op = static_cast<float*>(a.o) + (static_cast<long long>(b) * a.Hq +
                                          h) * a.Tq * static_cast<long long>(D);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= a.Tq) continue;
    const float inv = l[i] == 0.f ? 1.f : l[i];  // fully masked row: 0
#pragma unroll
    for (int j = 0; j < DV; ++j)
      op[static_cast<long long>(t) * D + tx * DV + j] = acc[i][j] / inv;
  }
}

template <int D>
int launch_f32(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t bytes =
      sizeof(float) * (D * kLQ + D * kLK + kBK * D + kBQ * kLK);
  static_assert(bytes <= 232448, "over the block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      attn_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.Hq, B);
  attn_f32_kernel<D><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------
// K/V ring depth: 3, or 2 at DP = 256 (shared memory)
constexpr int stages_for(int DP) { return DP > 192 ? 2 : 3; }
constexpr int kBox = 64 * 128;        // one TMA box: 64 rows x 128 bytes
constexpr int kSw = 1024;             // 128-byte swizzle atom: 8 rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// One 4-d TMA box (d, t, h, b) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma m64nNk16, f32 += bf16 x bf16. ss: A and B from shared memory,
// both K-major; rs: A from registers, B MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32],
    uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

struct Bf16Args {
  const int32_t* kv_len;  // (B,) or null for Tk
  __nv_bfloat16* o;       // (B, Hq, Tq, D), contiguous
  int Hq, Hkv, Tq, Tk, D;
  int causal, window;     // window <= 0: none
  float scale_log2;       // D^-0.5 * log2(e)
};

// Visible KV tiles [lo, hi) of the query rows q0 .. q0+rows-1; also
// whether every (row, key) pair of a tile inside is visible ("full").
struct TileRange {
  int lo, hi, kv_end, qpos_first, qpos_last;
};

__device__ __forceinline__ TileRange tile_range(const Bf16Args& a, int b,
                                                int q0) {
  TileRange r;
  r.kv_end = a.Tk;
  if (a.kv_len != nullptr) r.kv_end = min(max(a.kv_len[b], 0), a.Tk);
  const int off = a.Tk - a.Tq;
  r.qpos_first = q0 + off;
  r.qpos_last = min(q0 + kBQ, a.Tq) - 1 + off;
  r.hi = (r.kv_end + kBK - 1) / kBK;
  if (a.causal)
    r.hi = min(r.hi, r.qpos_last < 0 ? 0 : r.qpos_last / kBK + 1);
  r.lo = 0;
  if (a.window > 0) {
    const int first_key = r.qpos_first - a.window + 1;
    r.lo = first_key > 0 ? first_key / kBK : 0;
  }
  return r;
}

// Shared memory: Q (NC heads x NB boxes), then ST x (K, V) of NB
// boxes each, every box 1024-byte aligned for the swizzle, then the
// barriers.
template <int DP, int NC>
struct Smem {
  static constexpr int NB = DP / 64;  // 128-byte boxes per row
  static constexpr int ST = stages_for(DP);
  static constexpr int q = 0;
  static constexpr int k = q + NC * NB * kBox;
  static constexpr int v = k + ST * NB * kBox;
  static constexpr int bars = v + ST * NB * kBox;
  static constexpr int bytes = bars + 8 * (1 + 2 * ST);
  static_assert(bytes + kSw <= 232448, "over the block's shared memory");
};

// grid (Hq / NC, B, query tiles); block 128 * (NC + 1)
template <int DP, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    attn_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, Bf16Args a) {
  using L = Smem<DP, NC>;
  constexpr int NB = L::NB;
  constexpr int kStages = L::ST;
  constexpr int NO = DP / 2;  // O accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSw - 1) & ~uint32_t(kSw - 1);
  const uint32_t qbar = base + L::bars;
  auto full = [&](int s) { return base + L::bars + 8 * (1 + s); };
  auto empty = [&](int s) { return base + L::bars + 8 * (1 + kStages + s); };

  const int h0 = blockIdx.x * NC;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest first
  const int hk = h0 / (a.Hq / a.Hkv);
  const TileRange tr = tile_range(a, b, q0);
  const int n_vis = max(tr.hi - tr.lo, 0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread starts every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n_vis > 0) {
      mbar_expect_tx(qbar, NC * NB * kBox);
      for (int c = 0; c < NC; ++c)
        for (int x = 0; x < NB; ++x)
          tma_load(base + L::q + (c * NB + x) * kBox, &tq, x * 64, q0,
                   h0 + c, b, qbar);
      for (int i = 0; i < n_vis; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * NB * kBox);
        const int k0 = (tr.lo + i) * kBK;
        for (int x = 0; x < NB; ++x) {
          tma_load(base + L::k + (s * NB + x) * kBox, &tk, x * 64, k0, hk, b,
                   full(s));
          tma_load(base + L::v + (s * NB + x) * kBox, &tv, x * 64, k0, hk, b,
                   full(s));
        }
      }
    }
    return;
  }

  // ---- consumer: query head h0 + wg - 1 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int h = h0 + wg - 1;
  const int t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4;  // rows r0 and r0 + 8
  const int cq = 2 * (t % 4);                   // column of d[0] in an n8
  const int off = a.Tk - a.Tq;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  const uint32_t qs = base + L::q + (wg - 1) * NB * kBox;
  if (n_vis > 0) mbar_wait(qbar, 0);
  for (int i = 0; i < n_vis; ++i) {
    const int s = i % kStages;
    const int k0 = (tr.lo + i) * kBK;
    mbar_wait(full(s), (i / kStages) & 1);

    // S = Q K^T: D/16 k-steps of 16, 32 bytes each inside a 128-byte row
    float sc[32];
    const uint32_t ks = base + L::k + s * NB * kBox;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (kk * 16 >= a.D) break;
      const uint32_t step = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_ss_n64(sc, sw128_desc(qs + step, 16, kSw),
                   sw128_desc(ks + step, 16, kSw), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // mask only tiles that cross an edge of the visible region
    bool full_tile = k0 + kBK <= tr.kv_end;
    if (a.causal) full_tile = full_tile && k0 + kBK - 1 <= tr.qpos_first;
    if (a.window > 0)
      full_tile = full_tile && k0 > tr.qpos_last - a.window;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float x = sc[j] * a.scale_log2;
      if (!full_tile) {
        const int qpos = q0 + r0 + ((j & 2) ? 8 : 0) + off;
        const int kpos = k0 + 8 * (j / 4) + cq + (j & 1);
        bool ok = kpos < tr.kv_end;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window > 0) ok = ok && kpos > qpos - a.window;
        x = ok ? x : -CUDART_INF_F;
      }
      sc[j] = x;
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
    }
    float corr[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 threads of a row are lanes differing in their low 2 bits
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == -CUDART_INF_F ? 0.f : m_new;  // no key seen yet
      corr[r] = exp2f(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] *= corr[(j >> 1) & 1];

    // p in f32 -> p_hi + p_lo, packed as wgmma's A fragments
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int r = (j >> 1) & 1;
      const float p0 = exp2f(sc[j] - mu[r]);
      const float p1 = exp2f(sc[j + 1] - mu[r]);
      l[r] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          p0 - __low2float(hi), p1 - __high2float(hi));
      phi[j / 8][(j % 8) / 2] = *reinterpret_cast<const uint32_t*>(&hi);
      plo[j / 8][(j % 8) / 2] = *reinterpret_cast<const uint32_t*>(&lo);
    }

    // O += p_hi V + p_lo V: 4 k-steps of 16 keys, 2048 bytes each
    const uint32_t vs = base + L::v + s * NB * kBox;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = sw128_desc(vs + kk * 16 * 128, kBox, kSw);
      if constexpr (DP == 256) {
        wgmma_rs_n256(o, phi[kk], dv, 1);
        wgmma_rs_n256(o, plo[kk], dv, 1);
      } else if constexpr (DP == 192) {
        wgmma_rs_n192(o, phi[kk], dv, 1);
        wgmma_rs_n192(o, plo[kk], dv, 1);
      } else if constexpr (DP == 128) {
        wgmma_rs_n128(o, phi[kk], dv, 1);
        wgmma_rs_n128(o, plo[kk], dv, 1);
      } else {
        wgmma_rs_n64(o, phi[kk], dv, 1);
        wgmma_rs_n64(o, plo[kk], dv, 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(empty(s));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = l[r] == 0.f ? 0.f : 1.f / l[r];  // a row that sees no key: 0
  }
  __nv_bfloat16* op =
      a.o + (static_cast<long long>(b) * a.Hq + h) * a.Tq *
                static_cast<long long>(a.D);
#pragma unroll
  for (int j = 0; j < NO; j += 2) {
    const int row = q0 + r0 + ((j & 2) ? 8 : 0);
    const int col = 8 * (j / 4) + cq;
    const int r = (j >> 1) & 1;
    if (row < a.Tq && col < a.D)
      *reinterpret_cast<__nv_bfloat162*>(
          op + static_cast<long long>(row) * a.D + col) =
          __floats2bfloat162_rn(o[j] * l[r], o[j + 1] * l[r]);
  }
}

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query
// so that this library needs no link against libcuda.
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// A (d, t, h, b) bf16 tensor map with 64 x 64 boxes, 128-byte swizzle;
// strides in elements. Returns 0 or an error code.
int encode(CUtensorMap* map, const void* ptr, int D, int T, int H, int B,
           long long st, long long sh, long long sb) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(T), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(st) * 2, cuuint64_t(sh) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

template <int DP, int NC>
int launch_bf16(const CUtensorMap& tq, const CUtensorMap& tk,
                const CUtensorMap& tv, const Bf16Args& a, int B,
                cudaStream_t stream) {
  const int bytes = Smem<DP, NC>::bytes + kSw;  // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      attn_bf16_kernel<DP, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.Hq / NC, B, (a.Tq + kBQ - 1) / kBQ);
  attn_bf16_kernel<DP, NC><<<grid, 128 * (NC + 1), bytes, stream>>>(
      tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and
// returns 0, a CUDA error code, or 10000 + the CUresult of a failed
// tensor-map encode. D must be 32, 64, 128, 160 or 256; Tq, Hq must be positive
// and Hq a multiple of Hkv. bf16 != 0 selects __nv_bfloat16 for q, k, v
// and o (the tensor-core kernel; base addresses and the b, h, t strides
// must be 16-byte multiples, which the wrapper checks), else float.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const int32_t* kv_len,
    void* o, int B, int Hq, int Hkv, int Tq, int Tk, int D,
    long long sqb, long long sqh, long long sqt, long long skb,
    long long skh, long long skt, long long svb, long long svh,
    long long svt, int causal, int window, float scale, int bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    Args a{q, k, v, kv_len, o, Hq, Hkv, Tq, Tk,
           {sqb, sqh, sqt}, {skb, skh, skt}, {svb, svh, svt},
           causal, window, scale};
    switch (D) {
      case 32: return launch_f32<32>(a, B, s);
      case 64: return launch_f32<64>(a, B, s);
      case 128: return launch_f32<128>(a, B, s);
      case 160: return launch_f32<160>(a, B, s);
      case 256: return launch_f32<256>(a, B, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (D != 32 && D != 64 && D != 128 && D != 160 && D != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, D, Tq, Hq, B, sqt, sqh, sqb);
  if (err == 0) err = encode(&tk, k, D, Tk, Hkv, B, skt, skh, skb);
  if (err == 0) err = encode(&tv, v, D, Tk, Hkv, B, svt, svh, svb);
  if (err != 0) return err;
  Bf16Args a{kv_len, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Tq, Tk, D,
             causal, window, scale * 1.4426950408889634f};
  const bool pair = (Hq / Hkv) % 2 == 0;
  if (D == 256)
    return pair ? launch_bf16<256, 2>(tq, tk, tv, a, B, s)
                : launch_bf16<256, 1>(tq, tk, tv, a, B, s);
  if (D == 160)
    return pair ? launch_bf16<192, 2>(tq, tk, tv, a, B, s)
                : launch_bf16<192, 1>(tq, tk, tv, a, B, s);
  if (D == 128)
    return pair ? launch_bf16<128, 2>(tq, tk, tv, a, B, s)
                : launch_bf16<128, 1>(tq, tk, tv, a, B, s);
  return pair ? launch_bf16<64, 2>(tq, tk, tv, a, B, s)
              : launch_bf16<64, 1>(tq, tk, tv, a, B, s);
}
