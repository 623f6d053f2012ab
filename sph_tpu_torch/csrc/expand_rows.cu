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
// Design: two launches on the caller's stream.
//  1. Start table (`expand_starts_kernel`, one thread per row and one past
//     the end): start[r] = the first row whose key ≥ r·kRange, for every
//     range r of kRange slots and r = ranges (the end). Row i writes the
//     entries (range(key[i − 1]), range(key[i])], so every entry has
//     exactly one writer: no atomics, and no order of threads shows.
//  2. Placement (`expand_place_kernel`, one block per range of kRange
//     slots). The block takes its rows [start[r], start[r + 1]), keeps the
//     ones that fit (at most kRange: their targets are unique and in the
//     range) and stages their C values into shared memory, compacted by a
//     warp ballot + prefix sum, while a slot → staged-row map is built
//     beside them. Then it writes each of the C planes over its range once,
//     with 16-byte stores: the staged value where a row lands, the fill
//     everywhere else. Rows that do not fit cost one key read each.
// The TPU kernel's one-hot MXU product, bf16 3-way split, hi/lo target
// lanes and input windows are TPU machinery and have no counterpart here.
//
// What bounds it on the H100: memory traffic — the C·slots·4 bytes of
// output (~0.6 GB at the 1M-cell colony) written once, plus the rows that
// fit and the keys read once (each key is read a second time by the next
// row's thread, from L1). The start table is (slots/kRange + 1) ints.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxCols = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRange = 512;  // slots per placement block (ops/expand.py)

struct Fills {
  float v[kMaxCols];
};

__global__ void expand_starts_kernel(const int* __restrict__ key, int n,
                                     int ranges, int* __restrict__ start) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > n) return;
  const int cur = i < n ? min(key[i] / kRange, ranges) : ranges;
  const int prev = i > 0 ? min(key[i - 1] / kRange, ranges) : -1;
  for (int r = prev + 1; r <= cur; ++r) start[r] = i;
}

__global__ void __launch_bounds__(kThreads)
    expand_place_kernel(const float* __restrict__ rows,
                        const int* __restrict__ key,
                        const int* __restrict__ start,
                        float* __restrict__ out, int n, int ncol,
                        int slots, Fills fills) {
  __shared__ __align__(16) int map[kRange];
  __shared__ int warp_count[kWarps];
  extern __shared__ float staged[];  // [kRange][ncol]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s0 = blockIdx.x * kRange;
  const int span = min(kRange, slots - s0);  // a multiple of 4
  // Clamped, so that keys that break the precondition (not
  // nondecreasing) give a wrong plane but no access out of bounds.
  const int i0 = min(max(start[blockIdx.x], 0), n);
  const int i1 = min(max(start[blockIdx.x + 1], i0), n);
  for (int t = threadIdx.x; t < kRange; t += kThreads) map[t] = -1;
  __syncthreads();
  // Stage the rows that fit, in order; map their slots.
  int count = 0;
  for (int b = i0; b < i1; b += kThreads) {
    const int i = b + threadIdx.x;
    int k = 0;
    bool fit = false;
    if (i < i1) {
      k = key[i];
      fit = k >= s0 && k - s0 < span && (i == 0 || key[i - 1] != k);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, fit);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = count, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_count[w] : 0;
      total += warp_count[w];
    }
    const int j = before + __popc(ballot & ((1u << lane) - 1u));
    if (fit && j < kRange) {
      map[k - s0] = j;
      const float* src = rows + static_cast<size_t>(i) * ncol;
      for (int c = 0; c < ncol; ++c) staged[j * ncol + c] = src[c];
    }
    __syncthreads();
    count += total;
  }
  // Each plane over the range, once.
  const int4* map4 = reinterpret_cast<const int4*>(map);
  for (int c = 0; c < ncol; ++c) {
    const float f = fills.v[c];
    float4* dst = reinterpret_cast<float4*>(
        out + static_cast<size_t>(c) * slots + s0);
    for (int q = threadIdx.x; q < span / 4; q += kThreads) {
      const int4 m = map4[q];
      float4 v;
      v.x = m.x >= 0 ? staged[m.x * ncol + c] : f;
      v.y = m.y >= 0 ? staged[m.y * ncol + c] : f;
      v.z = m.z >= 0 ? staged[m.z * ncol + c] : f;
      v.w = m.w >= 0 ? staged[m.w * ncol + c] : f;
      dst[q] = v;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns a cudaError_t value (0 on success); nothing is synchronised.
// `key` is the pack's nondecreasing int32 key per sorted row; `start` is
// an int32 scratch of slots/kRange + 1 entries (rounded up), which the
// first launch writes in full.
extern "C" int sph_expand_rows(const float* rows, const int* key, int* start,
                               float* out, int n, int ncol, int slots,
                               const float* fills, void* stream) {
  if (ncol < 1 || ncol > kMaxCols || slots < 1 || slots % 4 != 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Fills f{};
  for (int c = 0; c < ncol; ++c) f.v[c] = fills[c];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ranges = (slots + kRange - 1) / kRange;
  expand_starts_kernel<<<n / kThreads + 1, kThreads, 0, s>>>(key, n, ranges,
                                                             start);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dyn = kRange * ncol * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(expand_place_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_place_kernel<<<ranges, kThreads, dyn, s>>>(rows, key, start, out, n,
                                                    ncol, slots, f);
  return static_cast<int>(cudaGetLastError());
}
