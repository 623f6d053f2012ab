// The contact pass's slot bookkeeping for Hopper (sm_90a): the slots
// kernel after the pack sort, and the gather back to particle order after
// K4.
//
// Replaces no Pallas kernel: the JAX package computes this bookkeeping
// inside its jitted step, where XLA fuses it (sph_tpu/physics/
// contact_dense.py `_rank_and_slots`, `gather_back`). The port ran it as
// eager PyTorch: an int32 cummax scan of run starts and some twenty
// elementwise launches after the sort, and a last-axis stack of K4's six
// planes into [slots, 6] (4-byte elements at a 24-byte stride) before one
// row gather. Here each is one launch.
//
// What they compute: bitwise what the plain versions (sph_tpu_torch/
// physics/contact_dense.py `_rank_and_slots`, `gather_back`) compute with
// eager PyTorch on the card.
//
//  `contact_slots_kernel` — per sorted row i of the cell ids cid_s: its
//     rank in its cell, clamped to K, by looking back at most K ids (the
//     rank is the length of the run of equal ids that ends at i, and only
//     min(rank, K) is ever used: no scan is needed); then
//       fits = alive && rank < K        (alive: cid < the dead id)
//       flat = fits ? cid·K + rank : slots
//       key  = cid·K + min(rank, K − 1)
//       slot_of[order[i]] = flat
//     in int32 arithmetic that wraps as torch's does. The count of alive
//     rows that do not fit (the overflow, a 0-dim int32) is summed without
//     a zeroed output: each block adds its count to the first int of the
//     stream's cursor, takes a ticket from the second, and the last block
//     moves the sum to `overflow` and leaves both ints zeroed (the cursor
//     K4 and A2 share, ops/contact.py `launch_on_cursor`).
//  `contact_gather_kernel` — per particle i and component c:
//     out[i, c] = plane_c[min(slot_of[i], slots − 1)] · (slot_of[i] < slots)
//     with an IEEE multiply (`__fmul_rn`) by the 0/1 factor, as the plain
//     version multiplies by its f32 mask: −0 and NaN keep the bits the
//     plain product gives (a row dropped from the layout reads NaN · 0 =
//     NaN where its clamped slot holds NaN, as the plain one does).
//
// What bounds them on the H100: memory traffic. The slots kernel reads
// the ids (4 B a row; the look-back hits L1) and the sort's order (8 B)
// and writes flat, key and slot_of (4 B each) and fits (1 B): 25 B a row,
// 26 MB at the 1M colony, 0.008 ms at 3.35 TB/s; its slot_of stores land
// at the order's scattered rows. The gather reads slot_of (4 B) and six
// f32 at the particle's slot, from six planes, and writes 24 B: 52 B a
// particle, 55 MB at 1M, 0.016 ms (each plane read as a 32-byte sector:
// 0.07 ms at worst). One thread a row, and one an output element in the
// gather, so that every warp's stores fill whole lines.

#include <cuda_runtime.h>

#include <cstdint>

#include "persistent.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kComps = 6;  // force[3], torque[3]

__global__ void __launch_bounds__(kThreads)
    contact_slots_kernel(const int* __restrict__ cid,
                         const long long* __restrict__ order, int n, int k,
                         int dead, int slots, int* __restrict__ flat,
                         uint8_t* __restrict__ fits, int* __restrict__ key,
                         int* __restrict__ slot_of, int* overflow,
                         int* cursor) {
  int over = 0;
  const int stride = static_cast<int>(gridDim.x) * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int c = cid[i];
    int r = 0;  // min(rank, k)
    while (r < k && i - r > 0 && cid[i - r - 1] == c) ++r;
    const bool alive = c < dead;
    const bool fit = alive && r < k;
    over += alive && !fit;
    const unsigned base =
        static_cast<unsigned>(c) * static_cast<unsigned>(k);
    const int f = fit ? static_cast<int>(base + r) : slots;
    flat[i] = f;
    fits[i] = fit;
    key[i] = static_cast<int>(base + static_cast<unsigned>(min(r, k - 1)));
    const long long o = order[i];
    // A permutation of [0, n) (torch.sort's indices); any other index is
    // not written.
    if (static_cast<unsigned long long>(o) <
        static_cast<unsigned long long>(n)) {
      slot_of[o] = f;
    }
  }
  // The block's overflow, summed over its threads' rows, then the grid's
  // through the cursor.
  __shared__ int warp_sum[kThreads / 32];
  int s = over;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    if (total != 0) atomicAdd(cursor, total);
    __threadfence();  // the block's sum before its ticket
    if (atomicAdd(cursor + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      __threadfence();
      *overflow = atomicExch(cursor, 0);
      cursor[1] = 0;
    }
  }
}

struct Planes {
  const float* p[kComps];
};

__global__ void __launch_bounds__(kThreads)
    contact_gather_kernel(Planes planes, const int* __restrict__ slot_of,
                          int n, int slots, float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n * kComps) return;
  const int i = t / kComps;
  const int c = t - i * kComps;
  const int s = slot_of[i];
  const float* plane = planes.p[0];
#pragma unroll
  for (int j = 1; j < kComps; ++j) {
    if (c == j) plane = planes.p[j];
  }
  // slot_of lies in [0, slots] (the slots kernel's flat); the clamp keeps
  // any other value inside the planes.
  const int idx = min(max(s, 0), slots - 1);
  out[t] = __fmul_rn(__ldg(plane + idx), s < slots ? 1.f : 0.f);
}

}  // namespace

// The slots kernel. cid [n] int32 (the sorted cell ids), order [n] int64
// (the sort's permutation); out: flat, key, slot_of [n] int32, fits [n]
// bool, overflow a 0-dim int32, all fresh. `dead` is the dead rows' cell
// id (nz·ny·nx_pad), slots = dead·k < 2^31, 1 ≤ k. `cursor`: two int32
// zeros of the stream, left zeroed. `device` is the current device.
extern "C" int sph_contact_slots(const int* cid, const long long* order,
                                 int n, int k, int dead, int slots, int* flat,
                                 uint8_t* fits, int* key, int* slot_of,
                                 int* overflow, int* cursor, int device,
                                 void* stream) {
  if (n < 0 || k < 1 || dead < 0 || slots < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int resident = 0;
  const cudaError_t rc = sph::persistent_grid(
      reinterpret_cast<const void*>(contact_slots_kernel), kThreads, 0,
      device, &resident);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // A block a tile of rows, at most the resident ones; one block where
  // there is no row, so that `overflow` is written.
  const int need = (n + kThreads - 1) / kThreads;
  const int grid = need < 1 ? 1 : (need < resident ? need : resident);
  contact_slots_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      cid, order, n, k, dead, slots, flat, fits, key, slot_of, overflow,
      cursor);
  return static_cast<int>(cudaGetLastError());
}

// The gather back. planes (host, 6 device pointers): K4's force and
// torque planes, `slots` floats each; slot_of [n] int32; out [n, 6] f32,
// fresh. n·6 < 2^31.
extern "C" int sph_contact_gather(const void* const* planes,
                                  const int* slot_of, float* out, int n,
                                  int slots, void* stream) {
  if (n < 0 || slots < 1 ||
      static_cast<long long>(n) * kComps >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  Planes p;
  for (int c = 0; c < kComps; ++c) {
    p.p[c] = static_cast<const float*>(planes[c]);
  }
  const int grid = (n * kComps + kThreads - 1) / kThreads;
  contact_gather_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p, slot_of, n,
                                                               slots, out);
  return static_cast<int>(cudaGetLastError());
}
