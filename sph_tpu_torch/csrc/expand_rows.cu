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
// order, go to the ascending unique slot targets `flat`; a row whose
// target is `slots` (it did not fit its cell, or is dead) writes nothing;
// every other slot of column c holds fills[c]. Output: C planes of `slots`.
//
// Design: two launches on the caller's stream. The fill pass writes every
// plane with 16-byte stores (slots is a multiple of 4: the lane axis is a
// multiple of 128). The placement pass runs one thread per sorted row and
// writes its C columns; the targets are unique, so no two threads write one
// address and the result does not depend on their order. The TPU kernel's
// one-hot MXU product, bf16 3-way split, hi/lo target lanes and input
// windows are TPU machinery and have no counterpart here.
//
// What bounds it on the H100: memory traffic — C·slots·4 bytes of fills
// written (~0.6 GB at the 1M-cell colony) dominate N·(C+1)·4 bytes of rows
// and targets read. The placement pass's column writes are scattered but
// land on ~1/13 of the slots that the fill pass already brought through L2.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kThreads = 256;

struct Fills {
  float v[kMaxCols];
};

__global__ void expand_fill_kernel(float* __restrict__ out, int slots4,
                                   int ncol, Fills fills) {
  const long long total = static_cast<long long>(slots4) * ncol;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float f = fills.v[i / slots4];
    out4[i] = make_float4(f, f, f, f);
  }
}

__global__ void expand_place_kernel(const float* __restrict__ rows,
                                    const int* __restrict__ flat,
                                    float* __restrict__ out, int n, int ncol,
                                    int slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = flat[i];
  if (t < 0 || t >= slots) return;
  const float* row = rows + static_cast<long long>(i) * ncol;
  for (int c = 0; c < ncol; ++c) {
    out[static_cast<long long>(c) * slots + t] = row[c];
  }
}

}  // namespace

extern "C" int sph_expand_rows(const float* rows, const int* flat,
                               float* out, int n, int ncol, int slots,
                               const float* fills, void* stream) {
  if (ncol < 1 || ncol > kMaxCols || slots % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Fills f{};
  for (int c = 0; c < ncol; ++c) f.v[c] = fills[c];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slots4 = slots / 4;
  const long long total = static_cast<long long>(slots4) * ncol;
  long long fill_blocks = (total + kThreads - 1) / kThreads;
  if (fill_blocks > 132 * 32) fill_blocks = 132 * 32;
  if (fill_blocks < 1) fill_blocks = 1;
  expand_fill_kernel<<<static_cast<int>(fill_blocks), kThreads, 0, s>>>(
      out, slots4, ncol, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    expand_place_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        rows, flat, out, n, ncol, slots);
  }
  return static_cast<int>(cudaGetLastError());
}
