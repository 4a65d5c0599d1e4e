// Aggregated-tag-array probe for Hopper: R request tags against the
// (S, W) tag arrays of C caches.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ata_tag_probe.py::_probe_kernel. The contract and
// the plain PyTorch version it is held against are in
// src/repro_torch/kernels/ata_tag_probe.py.
//
// Bound: launch latency. At the serving engine's shapes (R = C * K <=
// 288 requests, C <= 16 caches of 64 sets x 8 ways) a launch reads at
// most a few tens of KB of tags and does R * C * W <= 37k compares.
//
// Design: one thread per (request, cache) pair, cache index fastest.
// The thread reads its request's set row of its cache directly (the TPU
// kernel's masked-max one-hot gather over the set axis answered Mosaic's
// gather limits, which a GPU does not have) and keeps the first valid
// way whose tag matches. A set outside [0, S) reads nothing and reports
// a miss.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) ata_tag_probe_kernel(
    const int32_t* __restrict__ set_idx, const int32_t* __restrict__ qtag,
    const int32_t* __restrict__ tags, const uint8_t* __restrict__ valid,
    uint8_t* __restrict__ hits, int32_t* __restrict__ ways, int R, int C,
    int S, int W) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(R) * C) return;
  const int r = static_cast<int>(i / C);
  const int c = static_cast<int>(i - static_cast<long long>(r) * C);
  const int s = set_idx[r];
  const int32_t tag = qtag[r];
  bool hit = false;
  int way = 0;  // 0 where nothing matches, like argmax
  if (s >= 0 && s < S) {
    const long long off = (static_cast<long long>(c) * S + s) * W;
    for (int w = 0; w < W; ++w) {
      if (tags[off + w] == tag && valid[off + w]) {
        hit = true;
        way = w;
        break;
      }
    }
  }
  hits[i] = hit;
  ways[i] = way;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and
// returns cudaGetLastError() (0 = launched). R * C must be positive.
extern "C" int ata_tag_probe_launch(const int32_t* set_idx,
                                    const int32_t* qtag,
                                    const int32_t* tags,
                                    const uint8_t* valid, uint8_t* hits,
                                    int32_t* ways, int R, int C, int S,
                                    int W, void* stream) {
  const long long n = static_cast<long long>(R) * C;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  ata_tag_probe_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      set_idx, qtag, tags, valid, hits, ways, R, C, S, W);
  return static_cast<int>(cudaGetLastError());
}
