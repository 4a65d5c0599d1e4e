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
// most a few tens of KB of tags and does R * C * W <= 37k compares, so
// what a launch costs beyond the launch itself is its chain of
// dependent memory round trips.
//
// Design: two round trips per launch, whatever W and wherever a row
// matches.
//  * A group of g lanes per (request, cache) pair, cache index fastest;
//    g is the power of two >= W, at most 32 (a whole warp for W > 32,
//    whose lanes then take ways lane, lane + 32, ...).
//  * The group reads its request's set and tag (one round trip), then
//    every lane issues the loads of all its ways before any compare (the
//    second), and __ballot_sync with __ffs over the group's bits gives
//    the first matching way: no early exit, no per-way chain. Nothing
//    matches: way 0, as argmax gives. A set outside [0, S) reads nothing
//    and reports a miss.
//  * tags is read through its three element strides, so the serving
//    engine probes the tag lane of its packed directory in place
//    (dir[:C * S, :, 0], way stride 2) instead of copying it first.
//    valid is contiguous (C, S, W).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// NS: way slices of 32 per lane whose loads are all issued first (1 for
// W <= 32, 2 for W <= 64); 0 for any W, one slice per round trip.
template <int NS>
__global__ void __launch_bounds__(kThreads) ata_tag_probe_kernel(
    const int32_t* __restrict__ set_idx, const int32_t* __restrict__ qtag,
    const int32_t* __restrict__ tags, const uint8_t* __restrict__ valid,
    uint8_t* __restrict__ hits, int32_t* __restrict__ ways, int R, int C,
    int S, int W, int lg, long long sc, long long ss, long long sw) {
  constexpr int kSlices = NS > 0 ? NS : 1;  // slices per pass
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int g = 1 << lg;
  const long long i = t >> lg;               // (request, cache) pair
  const int j = static_cast<int>(t & (g - 1));  // lane in the group
  const int base = (threadIdx.x & 31) & ~(g - 1);
  const unsigned low = g == 32 ? kFull : (1u << g) - 1;
  const bool live = i < static_cast<long long>(R) * C;
  int c = 0, s = -1;
  int32_t tag = 0;
  if (live) {
    const int r = static_cast<int>(i / C);
    c = static_cast<int>(i - static_cast<long long>(r) * C);
    s = set_idx[r];
    tag = qtag[r];
  }
  const bool in_set = live && s >= 0 && s < S;
  const long long toff = in_set ? c * sc + s * ss : 0;
  const long long voff = in_set ? (static_cast<long long>(c) * S + s) * W : 0;
  const int passes = NS > 0 ? 1 : (W + 31) / 32;

  int way = -1;  // first matching way
  for (int pass = 0; pass < passes; ++pass) {
    int32_t tv[kSlices];
    uint8_t vv[kSlices];
#pragma unroll
    for (int k = 0; k < kSlices; ++k) {  // every load before any compare
      const int w = j + g * (pass * kSlices + k);
      tv[k] = 0;
      vv[k] = 0;
      if (in_set && w < W) {
        tv[k] = tags[toff + w * sw];
        vv[k] = valid[voff + w];
      }
    }
#pragma unroll
    for (int k = 0; k < kSlices; ++k) {
      const unsigned b =
          (__ballot_sync(kFull, vv[k] && tv[k] == tag) >> base) & low;
      if (way < 0 && b) way = g * (pass * kSlices + k) + __ffs(b) - 1;
    }
  }
  if (live && j == 0) {
    hits[i] = way >= 0;
    ways[i] = way >= 0 ? way : 0;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. tags is read at element
// strides (sc, ss, sw); the other arrays are contiguous. Launches on
// `stream` and returns cudaGetLastError() (0 = launched). R * C must be
// positive.
extern "C" int ata_tag_probe_launch(const int32_t* set_idx,
                                    const int32_t* qtag,
                                    const int32_t* tags,
                                    const uint8_t* valid, uint8_t* hits,
                                    int32_t* ways, int R, int C, int S,
                                    int W, long long sc, long long ss,
                                    long long sw, void* stream) {
  int lg = 0;
  while ((1 << lg) < W && lg < 5) ++lg;
  const long long n = (static_cast<long long>(R) * C) << lg;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W <= 32)
    ata_tag_probe_kernel<1><<<blocks, kThreads, 0, st>>>(
        set_idx, qtag, tags, valid, hits, ways, R, C, S, W, lg, sc, ss, sw);
  else if (W <= 64)
    ata_tag_probe_kernel<2><<<blocks, kThreads, 0, st>>>(
        set_idx, qtag, tags, valid, hits, ways, R, C, S, W, lg, sc, ss, sw);
  else
    ata_tag_probe_kernel<0><<<blocks, kThreads, 0, st>>>(
        set_idx, qtag, tags, valid, hits, ways, R, C, S, W, lg, sc, ss, sw);
  return static_cast<int>(cudaGetLastError());
}
