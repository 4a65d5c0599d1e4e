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
//  * grid = P simulation points, one CTA each; a CTA walks its R
//    requests in chunks of kThreads, one request per thread, so any R
//    works (R > kThreads, R not a multiple of 32);
//  * a thread scans only its own set row in its own cache and in the G
//    caches of its cluster (lowest id first, stopping at the first peer
//    that hits);
//  * port arbitration: the C per-port counters live in shared memory
//    and carry from chunk to chunk (the TPU kernel carried them across
//    its sequential grid, which Hopper's unordered blocks cannot do).
//    A request's rank is the carried count at its port plus the earlier
//    lanes of its chunk with the same port;
//  * psize is read from the final counters, inside the kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct RowHit {
  bool hit;    // some valid way holds the tag
  int way;     // first such way (0 when none, like argmax)
  bool dirty;  // some matching way is dirty
};

__device__ __forceinline__ RowHit scan_row(const int32_t* __restrict__ tags,
                                           const uint8_t* __restrict__ valid,
                                           const uint8_t* __restrict__ dirty,
                                           long long row, int W,
                                           int32_t tag) {
  RowHit r{false, 0, false};
  const long long off = row * W;
  for (int w = W - 1; w >= 0; --w) {  // descending: the last match kept
    if (tags[off + w] == tag && valid[off + w]) {  // is the first way
      r.hit = true;
      r.way = w;
      r.dirty = r.dirty || dirty[off + w];
    }
  }
  return r;
}

__global__ void __launch_bounds__(kThreads) ata_probe_rank_kernel(
    const int32_t* __restrict__ set_idx, const int32_t* __restrict__ qtag,
    const int32_t* __restrict__ core, const int32_t* __restrict__ cbase,
    const uint8_t* __restrict__ deny, const int32_t* __restrict__ tags,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ dirty,
    uint8_t* __restrict__ local_hit, int32_t* __restrict__ hit_way,
    uint8_t* __restrict__ remote_ok, int32_t* __restrict__ src_cache,
    int32_t* __restrict__ prank, int32_t* __restrict__ psize, int R, int C,
    int S, int W, int G) {
  extern __shared__ int smem[];
  int* counts = smem;     // [C] requests ranked so far at each port
  int* keys = smem + C;   // [kThreads] this chunk's port per lane, -1 none

  const int tid = threadIdx.x;
  const long long req0 = static_cast<long long>(blockIdx.x) * R;
  const long long row0 = static_cast<long long>(blockIdx.x) * C * S;
  for (int c = tid; c < C; c += kThreads) counts[c] = 0;
  __syncthreads();

  for (int base = 0; base < R; base += kThreads) {
    const int r = base + tid;
    const long long q = req0 + r;
    int key = -1;
    if (r < R) {
      const int s = set_idx[q];
      const int32_t tag = qtag[q];
      const int self = core[q];
      const int cb = cbase[q];
      const RowHit own =
          scan_row(tags, valid, dirty, row0 + static_cast<long long>(self) * S + s, W, tag);
      int src = cb;
      bool any_remote = false;
      bool src_dirty = false;
      const int end = min(cb + G, C);
      for (int c = max(cb, 0); c < end; ++c) {
        if (c == self) continue;
        const RowHit peer =
            scan_row(tags, valid, dirty, row0 + static_cast<long long>(c) * S + s, W, tag);
        if (peer.hit) {
          src = c;
          any_remote = true;
          src_dirty = peer.dirty;
          break;
        }
      }
      const bool ok = !deny[q] && !own.hit && any_remote && !src_dirty;
      local_hit[q] = own.hit;
      hit_way[q] = own.way;
      remote_ok[q] = ok;
      src_cache[q] = src;
      key = ok ? src : -1;
    }
    keys[tid] = key;
    __syncthreads();
    if (r < R) {
      int rank = 0;
      if (key >= 0) {
        rank = counts[key];
        for (int j = 0; j < tid; ++j) rank += keys[j] == key;
      }
      prank[q] = rank;
    }
    __syncthreads();  // every lane has read counts before they move on
    if (key >= 0) atomicAdd(&counts[key], 1);
    __syncthreads();  // counts and keys settled for the next chunk
  }

  // Same request-to-thread mapping as above: each thread reads back the
  // remote_ok/src_cache it wrote itself.
  for (int r = tid; r < R; r += kThreads) {
    const long long q = req0 + r;
    psize[q] = remote_ok[q] ? counts[src_cache[q]] : 0;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int ata_probe_rank_launch(
    const int32_t* set_idx, const int32_t* qtag, const int32_t* core,
    const int32_t* cbase, const uint8_t* deny, const int32_t* tags,
    const uint8_t* valid, const uint8_t* dirty, uint8_t* local_hit,
    int32_t* hit_way, uint8_t* remote_ok, int32_t* src_cache, int32_t* prank,
    int32_t* psize, int P, int R, int C, int S, int W, int G, void* stream) {
  const size_t smem = static_cast<size_t>(C + kThreads) * sizeof(int);
  ata_probe_rank_kernel<<<P, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      set_idx, qtag, core, cbase, deny, tags, valid, dirty, local_hit,
      hit_way, remote_ok, src_cache, prank, psize, R, C, S, W, G);
  return static_cast<int>(cudaGetLastError());
}
