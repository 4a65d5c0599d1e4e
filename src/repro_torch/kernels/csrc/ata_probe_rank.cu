// Fused ATA probe + winner pick + remote-port arbitration for Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ata_probe_rank.py::_probe_rank_kernel. The contract
// and the plain PyTorch version it is held against are in
// src/repro_torch/kernels/ata_probe_rank.py.
//
// Bound: launch latency and the tag rows it reads (P * R * G * W int32
// tags plus valid/dirty bytes, L2-resident at the simulator's sizes);
// the integer compares are negligible next to them.
//
// Design:
//  * one thread-block cluster of K CTAs per simulation point (K from the
//    wrapper: enough CTAs to fill the card, at most 8); CTA k of a
//    cluster takes the k-th contiguous chunk of the point's requests, in
//    rounds of one request per thread;
//  * a warp probes one request at a time, its own row and then the
//    cluster peers in id order. Lane i of each group of W / 8 lanes reads
//    ways 8i .. 8i + 7 of one row (two 16-byte loads of tags, 8 bytes
//    each of valid and dirty; compares as bit masks), so at W = 64 a
//    warp reads 4 rows per load, and the loads of kSets such rows per
//    lane are issued before any compare: the paper's 10 rows of a
//    request cost one memory round trip, and a lane's work per row is
//    shared by 8 ways. (W not a multiple of 8, W > 256 or
//    unaligned arrays: lane l reads ways l, l + 32, ... of one row.)
//    Each lane keeps its own first matching way of the own row and its
//    first matching peer row (and that row's dirty bit); two
//    __reduce_min_sync and one __any_sync then give the request's way,
//    its lowest-id hitting peer and whether that copy is dirty. Every
//    row is probed before the peer is picked;
//  * a request's fields are loaded once per round by the warp's lanes
//    and broadcast with __shfl_sync;
//  * port ranks in arrival order: one warp walks the round's ports
//    (kept in shared memory) 32 at a time, ranking each with
//    __match_any_sync plus the C per-port counts carried in shared
//    memory (the TPU kernel carried its (1, C) counts block across its
//    sequential grid, which Hopper's unordered blocks do not have);
//  * across the cluster, a request adds the counts of the earlier CTAs
//    at its port, read from their shared memory (distributed shared
//    memory, after a cluster barrier); psize is the sum over all K.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSets = 3;  // loads in flight together per lane, each a row
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Probe {
  bool own_hit;     // some valid way of the own row holds the tag
  int own_way;      // first such way (0 when none, like argmax)
  bool any_remote;  // some cluster peer (not self) hits
  int src;          // lowest-id hitting peer, else the cluster base
  bool src_dirty;   // some matching way of that peer is dirty
};

// Rows 0 .. n_rows - 1 of a request: the own row, then the cluster
// peers in id order.
__device__ __forceinline__ int row_cache(int j, int self, int c0,
                                         bool self_in) {
  if (j == 0) return self;
  const int c = c0 + j - 1;
  return self_in && c >= self ? c + 1 : c;
}

constexpr unsigned kNone = 0xffffffffu;

// What one lane has seen of a request's rows: the first own way that
// matches, the first peer row with a match among its ways and whether a
// matching way of that row is dirty.
struct LaneSeen {
  unsigned way;  // kNone when none
  unsigned row;  // kNone when none
  bool dirty;
  __device__ __forceinline__ void see(int j, unsigned w, bool m, bool d) {
    if (!m) return;
    if (j == 0) {
      way = min(way, w);
    } else if (static_cast<unsigned>(j) < row) {
      row = j;
      dirty = d;
    } else if (static_cast<unsigned>(j) == row) {
      dirty = dirty || d;
    }
  }
};

// Bit k set where byte k of x (a bool: 0 or 1) is set, for k < 4.
__device__ __forceinline__ unsigned byte_bits(unsigned x) {
  return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

// Warp-wide probe of one request against its own row and its cluster's
// rows (every lane returns the same result). Each lane folds its ways
// of every row into a LaneSeen; three warp reductions then give the
// request's answer (the first matching way of the own row is the least
// way over the lanes, the first hitting peer the least row).
//
// VEC (W a multiple of 8, at most 256, arrays aligned): lane i of a
// group of lpr = 2^lg lanes reads ways 8i .. 8i + 7 of one row (two
// 16-byte loads of tags, 8 bytes each of valid and dirty), and the 32 /
// lpr groups of the warp read as many rows at once: at W = 64 a warp
// covers 4 rows per load, and kSets of them are in flight before any
// compare (the paper's 10 rows of a request in one round trip). The
// compares of a lane's 8 ways become bit masks. Otherwise (any W): lane
// l reads ways l, l + 32, ... of one row, kSets rows at a time, one
// 32-way slice per pass.
template <bool VEC>
__device__ __forceinline__ Probe probe_request(
    const int32_t* __restrict__ tags, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ dirty, long long row0, int C, int S, int W,
    int G, int lg, int s, int32_t tag, int self, int cb, int lane) {
  const int c0 = max(cb, 0);
  const int c1 = min(cb + G, C);
  const bool self_in = self >= c0 && self < c1;
  const int n_rows = 1 + max(c1 - c0, 0) - (self_in ? 1 : 0);
  const long long sw = static_cast<long long>(S) * W;  // cache stride
  const long long base = (row0 * S + s) * W;           // cache 0's row
  LaneSeen seen{kNone, kNone, false};
  if constexpr (VEC) {
    const int g = lane >> lg;               // this lane's row in a set
    const int i = lane & ((1 << lg) - 1);   // its 8 ways: 8i .. 8i + 7
    const int rps = 32 >> lg;               // rows per set
    const bool has = 8 * i < W;
    for (int j0 = 0; j0 < n_rows; j0 += kSets * rps) {
      int4 t0[kSets], t1[kSets];
      uint2 vv[kSets], dv[kSets];
#pragma unroll
      for (int k = 0; k < kSets; ++k) {  // every load, then compares
        const int j = j0 + k * rps + g;
        t0[k] = t1[k] = make_int4(0, 0, 0, 0);
        vv[k] = dv[k] = make_uint2(0u, 0u);
        if (j < n_rows && has) {
          const long long off =
              base + row_cache(j, self, c0, self_in) * sw + 8 * i;
          const int4* tp = reinterpret_cast<const int4*>(tags + off);
          t0[k] = tp[0];
          t1[k] = tp[1];
          vv[k] = *reinterpret_cast<const uint2*>(valid + off);
          dv[k] = *reinterpret_cast<const uint2*>(dirty + off);
        }
      }
#pragma unroll
      for (int k = 0; k < kSets; ++k) {
        const unsigned mt =
            (t0[k].x == tag) | (t0[k].y == tag) << 1 | (t0[k].z == tag) << 2 |
            (t0[k].w == tag) << 3 | (t1[k].x == tag) << 4 |
            (t1[k].y == tag) << 5 | (t1[k].z == tag) << 6 |
            (t1[k].w == tag) << 7;
        const unsigned m =
            mt & (byte_bits(vv[k].x) | byte_bits(vv[k].y) << 4);
        const unsigned d = byte_bits(dv[k].x) | byte_bits(dv[k].y) << 4;
        seen.see(j0 + k * rps + g, 8 * i + __ffs(m) - 1, m != 0,
                 (m & d) != 0);
      }
    }
  } else {
    const int passes = (W + 31) / 32;
    for (int j0 = 0; j0 < n_rows; j0 += kSets) {
      for (int pass = 0; pass < passes; ++pass) {
        int32_t tv[kSets];
        uint8_t vv[kSets], dv[kSets];
        const int w = lane + 32 * pass;
#pragma unroll
        for (int k = 0; k < kSets; ++k) {
          tv[k] = 0;
          vv[k] = dv[k] = 0;
          if (j0 + k < n_rows && w < W) {
            const long long off =
                base + row_cache(j0 + k, self, c0, self_in) * sw + w;
            tv[k] = tags[off];
            vv[k] = valid[off];
            dv[k] = dirty[off];
          }
        }
#pragma unroll
        for (int k = 0; k < kSets; ++k) {
          const bool m = vv[k] && tv[k] == tag;
          seen.see(j0 + k, w, m, m && dv[k]);
        }
      }
    }
  }
  const unsigned way = __reduce_min_sync(kFull, seen.way);
  const unsigned row = __reduce_min_sync(kFull, seen.row);
  // a lane whose first peer match is later holds no match in that row
  const bool dirt = __any_sync(kFull, seen.row == row && seen.dirty);
  Probe out{way != kNone, way != kNone ? static_cast<int>(way) : 0,
            row != kNone, cb, row != kNone && dirt};
  if (row != kNone) out.src = row_cache(row, self, c0, self_in);
  return out;
}

// remote_ok, src_cache and prank are written in one phase and read back
// in the last, so they carry no __restrict__.
template <bool VEC>
__global__ void __launch_bounds__(kThreads) ata_probe_rank_kernel(
    const int32_t* __restrict__ set_idx, const int32_t* __restrict__ qtag,
    const int32_t* __restrict__ core, const int32_t* __restrict__ cbase,
    const uint8_t* __restrict__ deny, const int32_t* __restrict__ tags,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ dirty,
    uint8_t* __restrict__ local_hit, int32_t* __restrict__ hit_way,
    uint8_t* remote_ok, int32_t* src_cache, int32_t* prank,
    int32_t* __restrict__ psize, int R, int C, int S, int W, int G, int lg) {
  extern __shared__ int smem[];
  int* counts = smem;     // [C] this CTA's requests so far per port
  int* keys = smem + C;   // [kThreads] this round's ports, -1 for none
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int p = blockIdx.x / K;
  const int chunk = (R + K - 1) / K;
  const int lo = min(rank * chunk, R);
  const int hi = min(lo + chunk, R);
  const long long req0 = static_cast<long long>(p) * R;
  const long long row0 = static_cast<long long>(p) * C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < C; c += kThreads) counts[c] = 0;

  // the chunk in rounds of kThreads requests
  for (int b0 = lo; b0 < hi; b0 += kThreads) {
    const int n_round = min(kThreads, hi - b0);
    // 1. probe: warp w takes the round's requests w, w + kWarps, ...;
    //    lane t loads the t-th one's fields, broadcast by __shfl_sync
    const int i = warp + lane * kWarps;  // this lane's request in the round
    const long long qm = req0 + b0 + i;
    int s_l = 0, self_l = 0, cb_l = 0;
    int32_t tag_l = 0;
    bool deny_l = true;
    if (i < n_round) {
      s_l = set_idx[qm];
      tag_l = qtag[qm];
      self_l = core[qm];
      cb_l = cbase[qm];
      deny_l = deny[qm];
    }
    const int n = max(0, (n_round - warp + kWarps - 1) / kWarps);
    bool lh = false, ok = false;
    int hw = 0, src = 0;
    for (int t = 0; t < n; ++t) {
      const Probe pr = probe_request<VEC>(
          tags, valid, dirty, row0, C, S, W, G, lg, __shfl_sync(kFull, s_l, t),
          __shfl_sync(kFull, tag_l, t), __shfl_sync(kFull, self_l, t),
          __shfl_sync(kFull, cb_l, t), lane);
      if (lane == t) {
        lh = pr.own_hit;
        hw = pr.own_way;
        src = pr.src;
        ok = !deny_l && !pr.own_hit && pr.any_remote && !pr.src_dirty;
      }
    }
    if (i < n_round) {
      local_hit[qm] = lh;
      hit_way[qm] = hw;
      remote_ok[qm] = ok;
      src_cache[qm] = src;
      keys[i] = ok ? src : -1;
    }
    __syncthreads();

    // 2. ranks in arrival order, 32 requests at a time, carried counts
    if (warp == 0) {
      for (int b = 0; b < n_round; b += 32) {
        const int r = b + lane;
        const int key = r < n_round ? keys[r] : -1;
        const unsigned peers = __match_any_sync(kFull, key);
        const int before = key >= 0 ? counts[key] : 0;
        __syncwarp();  // every lane has read counts before they move
        if (key >= 0 && (peers >> lane) == 1u)  // the group's last lane
          counts[key] = before + __popc(peers);
        if (r < n_round)
          prank[req0 + b0 + r] =
              key >= 0 ? before + __popc(peers & ((1u << lane) - 1)) : 0;
        __syncwarp();
      }
    }
    __syncthreads();  // keys free for the next round
  }
  cluster.sync();  // every CTA's counts are final

  // 3. carry across the cluster: the earlier CTAs' counts at the port
  //    join the rank; all K of them make the group size
  for (int r = lo + static_cast<int>(threadIdx.x); r < hi; r += kThreads) {
    const long long q = req0 + r;
    int size = 0;
    if (remote_ok[q]) {
      const int key = src_cache[q];
      int v[kMaxCluster];
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k)  // all remote reads at once
        v[k] = k < K ? cluster.map_shared_rank(counts, k)[key] : 0;
      int off = 0;
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        size += v[k];
        off += k < rank ? v[k] : 0;
      }
      prank[q] += off;
    }
    psize[q] = size;
  }
  cluster.sync();  // no CTA leaves while another still reads its counts
}

template <bool VEC>
cudaError_t launch(cudaLaunchConfig_t* cfg, const int32_t* set_idx,
                   const int32_t* qtag, const int32_t* core,
                   const int32_t* cbase, const uint8_t* deny,
                   const int32_t* tags, const uint8_t* valid,
                   const uint8_t* dirty, uint8_t* local_hit,
                   int32_t* hit_way, uint8_t* remote_ok, int32_t* src_cache,
                   int32_t* prank, int32_t* psize, int R, int C, int S,
                   int W, int G, int lg) {
  return cudaLaunchKernelEx(cfg, ata_probe_rank_kernel<VEC>, set_idx,
                            qtag, core, cbase, deny, tags, valid, dirty,
                            local_hit, hit_way, remote_ok, src_cache, prank,
                            psize, R, C, S, W, G, lg);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches P clusters of K CTAs
// (1 <= K <= 8) on `stream` and returns the launch's CUDA error (0 =
// launched).
extern "C" int ata_probe_rank_launch(
    const int32_t* set_idx, const int32_t* qtag, const int32_t* core,
    const int32_t* cbase, const uint8_t* deny, const int32_t* tags,
    const uint8_t* valid, const uint8_t* dirty, uint8_t* local_hit,
    int32_t* hit_way, uint8_t* remote_ok, int32_t* src_cache, int32_t* prank,
    int32_t* psize, int P, int R, int C, int S, int W, int G, int K,
    void* stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(P) * K);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(C + kThreads) * sizeof(int);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec = W % 8 == 0 && W <= 256 &&
                   reinterpret_cast<uintptr_t>(tags) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(valid) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(dirty) % 8 == 0;
  int lg = 0;  // log2 of the lanes per row: 8 ways each
  while ((8 << lg) < W) ++lg;
  cudaError_t err =
      vec ? launch<true>(&cfg, set_idx, qtag, core, cbase, deny, tags, valid,
                         dirty, local_hit, hit_way, remote_ok, src_cache,
                         prank, psize, R, C, S, W, G, lg)
          : launch<false>(&cfg, set_idx, qtag, core, cbase, deny, tags,
                          valid, dirty, local_hit, hit_way, remote_ok,
                          src_cache, prank, psize, R, C, S, W, G, lg);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
