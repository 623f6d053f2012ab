// The contact pack's placement for Hopper (sm_90a): K5.
//
// Replaces: the Pallas kernel `_expand_kernel` (sph_tpu/ops/pallas/
// expand.py) as launched by `expand_rows`, and with it the probe variant
// `_kernel` of tools/probe_fix_expand.py (the same placement in other TPU
// encodings of the target lane).
//
// What it computes (bitwise the plain `_scatter_sorted` of
// sph_tpu_torch/physics/contact_dense.py, −0 and NaN payloads included,
// since it only copies bits): N rows of C f32 columns, in the pack sort's
// order, go to their slots; every other slot of column c holds fills[c].
// Output: C planes of `slots`.
//
// The row lookup. The kernel takes the pack's KEY per sorted row,
// key = cid·K + min(rank, K − 1) (`_rank_and_slots`), not the slot
// targets `flat`: `flat` is not monotone, since a row that does not fit
// its cell (rank ≥ K) carries flat = slots in the middle of the array, so
// no search over `flat` can find a range's rows once a cell overflows.
// The key is nondecreasing (the rows are sorted by cell id, ranks rise
// within a cell), equals `flat` on every row that fits, and tells which
// rows fit by itself: a row fits exactly when its key is below `slots`
// (dead rows carry the past-the-end cell id, so key ≥ slots) and differs
// from the key of the row before (the overflow rows of a cell repeat the
// key of its rank-(K − 1) row). Chosen over searching the cell ids because
// the key needs no rank and no second array: one int per row.
//
// Design: one launch on the caller's stream (`expand_place_kernel`),
// whose blocks each take a contiguous run of kChunk ranges of kRange
// slots.
//  1. Search. The block finds the first row of its first range, the first
//     row whose key ≥ its first slot, in the nondecreasing key: each round
//     its 256 threads probe 256 splitters that cut the window into 257
//     pieces, a barrier counts the splitters below the target
//     (__syncthreads_count), and the window narrows to the piece that
//     holds the answer; once it holds at most 256 rows, one last count over
//     them gives it. About log₂₅₇(N/256) rounds and the last: 3 dependent
//     reads at 2^20 rows, once per block (a warp's 32 splitters took 4,
//     and every read is a block's wait).
//  2. Per range, the row cursor carried from the range before: the block
//     reads kThreads keys from the cursor at a time, keeps the rows that
//     fit (at most kRange: their targets are unique and in the range) and
//     stages their C values into shared memory, compacted by a warp ballot
//     + prefix sum, while a slot → staged-row map is built beside them;
//     the cursor moves past the rows whose key is below the range's end (a
//     prefix of the batch), and a batch that is not all such rows ends the
//     range. Each batch's keys are loaded one batch ahead: the next range's
//     first keys are in flight while this range's planes are written. Then
//     the block writes each of the C planes over the range once, with
//     16-byte stores, the (plane, 4 slots) pairs spread over all its
//     threads: the staged value where a row lands, the fill everywhere
//     else. Rows that do not fit cost one key read each.
// So no start table is built and no launch but this one is made; the
// shared-memory limit and the blocks that fit on the card are asked of the
// CUDA runtime once per column count (csrc/persistent.cuh). The grid is not
// persistent: the time of a range depends on its rows, so blocks of a few
// ranges, scheduled by the hardware as others end, balance the card, where
// one run of ranges per resident block left SMs idle at the end; and a
// search a block costs as much as a range's loads, so one range a block
// is slower still (PERF.md: the chunk sizes measured at the 1M colony).
// Keys that break the precondition (not nondecreasing) give a wrong plane
// but no access out of bounds: every probe and the cursor stay in [0, n].
// The TPU kernel's one-hot MXU product, bf16 3-way split, hi/lo target
// lanes and input windows are TPU machinery and have no counterpart here.
//
// What bounds it on the H100: memory traffic — the C·slots·4 bytes of
// output (~0.6 GB at the 1M-cell colony) written once, plus the rows that
// fit and the keys read once (a batch's first key is read again for the
// row before it, from L1; a block's search, a few keys a thread).

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "persistent.cuh"

namespace {

constexpr int kMaxCols = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRange = 512;  // slots per range (ops/expand.py)
constexpr int kSplit = kThreads + 1;  // pieces a search round makes
constexpr int kChunk = 2;  // ranges a block takes, where the card is full

struct Fills {
  float v[kMaxCols];
};

// The first row whose key is ≥ target (n if none), by the whole block,
// every thread getting it: each round the kThreads threads probe kThreads
// splitters lo + ⌊span·(j + 1)/kSplit⌋ of the window [lo, hi), strictly
// inside it, a barrier counts those whose key is below target, and the
// window narrows to the piece that holds the answer, which lies in [lo,
// hi] throughout; once the window holds at most kThreads rows, one last
// count over them gives it (utils/verify.py `expand_search` is this search
// in plain PyTorch).
__device__ int first_at_least(const int* __restrict__ key, int n,
                              int target) {
  const int j = threadIdx.x;
  int lo = 0, hi = n;
  while (hi - lo > kThreads) {
    const long long span = hi - lo;
    const int p = lo + static_cast<int>(span * (j + 1) / kSplit);
    const int f = __syncthreads_count(key[p] < target);
    const int lo0 = lo;
    if (f > 0) lo = lo0 + static_cast<int>(span * f / kSplit) + 1;
    if (f < kThreads) hi = lo0 + static_cast<int>(span * (f + 1) / kSplit);
  }
  const int p = lo + j;
  return lo + __syncthreads_count(p < hi && key[p] < target);
}

__global__ void __launch_bounds__(kThreads)
    expand_place_kernel(const float* __restrict__ rows,
                        const int* __restrict__ key, float* __restrict__ out,
                        int n, int ncol, int slots, int chunk, Fills fills) {
  __shared__ __align__(16) int map[kRange];
  __shared__ int warp_fit[kWarps], warp_in[kWarps];
  __shared__ float fill[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
    if (threadIdx.x == c) fill[c] = fills.v[c];
  extern __shared__ float staged[];  // [kRange][ncol]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ranges = (slots + kRange - 1) / kRange;
  const int r_begin = blockIdx.x * chunk;
  const int r_end = min(r_begin + chunk, ranges);
  int cursor = first_at_least(key, n, r_begin * kRange);
  // This thread's row of the batch at the cursor: its key (INT_MAX past
  // the rows) and the key of the row before it, loaded a batch ahead — the
  // next range's first batch is loaded before this range's planes are
  // written, so its latency hides behind the stores.
  int k_next = INT_MAX, prev_next = 0;
  const auto load_batch = [&](int at) {
    const int i = at + static_cast<int>(threadIdx.x);
    k_next = i < n ? key[i] : INT_MAX;
    prev_next = i > 0 && i <= n ? key[i - 1] : 0;
  };
  load_batch(cursor);
  for (int r = r_begin; r < r_end; ++r) {
    const int s0 = r * kRange;
    const int span = min(kRange, slots - s0);  // a multiple of 4
    const int s1 = s0 + kRange;  // the range's end, for the cursor
    for (int t = threadIdx.x; t < kRange; t += kThreads) map[t] = -1;
    __syncthreads();
    // Stage the rows that fit, in order; map their slots.
    int count = 0;
    for (;;) {
      const int i = cursor + threadIdx.x;
      const int k = k_next;
      const bool fit = i < n && k >= s0 && k - s0 < span &&
                       (i == 0 || prev_next != k);
      const unsigned ballot = __ballot_sync(0xffffffffu, fit);
      const unsigned below = __ballot_sync(0xffffffffu, k < s1);
      if (lane == 0) {
        warp_fit[warp] = __popc(ballot);
        warp_in[warp] = __popc(below);
      }
      __syncthreads();
      int before = count, total = 0, taken = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? warp_fit[w] : 0;
        total += warp_fit[w];
        taken += warp_in[w];
      }
      const int j = before + __popc(ballot & ((1u << lane) - 1u));
      if (fit && j < kRange) {
        map[k - s0] = j;
        const float* src = rows + static_cast<size_t>(i) * ncol;
        for (int c = 0; c < ncol; ++c) staged[j * ncol + c] = src[c];
      }
      __syncthreads();
      count += total;
      cursor += taken;
      load_batch(cursor);  // this range's next batch, or the next range's
      if (taken < kThreads) break;
    }
    // Each plane over the range, once: the (plane, quad) pairs spread over
    // all the block's threads (a range has kRange/4 = 128 quads a plane).
    const int4* map4 = reinterpret_cast<const int4*>(map);
    const int quads = span / 4;
    for (int t = threadIdx.x; t < ncol * quads; t += kThreads) {
      const int c = t / quads, q = t - c * quads;
      const float f = fill[c];
      const int4 m = map4[q];
      float4 v;
      v.x = m.x >= 0 ? staged[m.x * ncol + c] : f;
      v.y = m.y >= 0 ? staged[m.y * ncol + c] : f;
      v.z = m.z >= 0 ? staged[m.z * ncol + c] : f;
      v.w = m.w >= 0 ? staged[m.w * ncol + c] : f;
      reinterpret_cast<float4*>(out + static_cast<size_t>(c) * slots +
                                s0)[q] = v;
    }
    // The map and the staged rows are read before the next range's.
    __syncthreads();
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns a cudaError_t value (0 on success); nothing is synchronised.
// `key` is the pack's nondecreasing int32 key per sorted row; `device` is
// the current device. Each block takes kChunk ranges, or one where the
// ranges would not give every block slot of the card kChunk (a small
// pack: ranges < 2 · resident blocks).
extern "C" int sph_expand_rows(const float* rows, const int* key, float* out,
                               int n, int ncol, int slots, const float* fills,
                               int device, void* stream) {
  if (ncol < 1 || ncol > kMaxCols || slots < 1 || slots % 4 != 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Fills f{};
  for (int c = 0; c < ncol; ++c) f.v[c] = fills[c];
  const int ranges = (slots + kRange - 1) / kRange;
  const int dyn = kRange * ncol * static_cast<int>(sizeof(float));
  int resident = 0;  // blocks that fit on the card at once
  const cudaError_t err = sph::persistent_grid(
      reinterpret_cast<const void*>(expand_place_kernel), kThreads, dyn,
      device, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk = std::max(1, std::min(kChunk, ranges / resident));
  const int grid = (ranges + chunk - 1) / chunk;
  expand_place_kernel<<<grid, kThreads, dyn,
                        static_cast<cudaStream_t>(stream)>>>(
      rows, key, out, n, ncol, slots, chunk, f);
  return static_cast<int>(cudaGetLastError());
}
