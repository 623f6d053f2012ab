// One stage of the staged dense-grid rebin for Hopper (sm_90a): K3.
//
// Replaces: the Pallas kernel `_stage_kernel` (sph_tpu/ops/pallas/rebin.py)
// as launched by `_run_stage` from `rebin_pallas`, one launch per axis, in
// the order in-row cells, rows, planes.
//
// What a stage computes (bitwise the plain `rebin` of
// sph_tpu_torch/sph/dense.py, itself bitwise the JAX twin): every cell
// column gathers the ≤ 3K candidates of itself and its two neighbours
// along the stage axis in SHIFT-MAJOR order (s = −1, 0, +1; then source
// slot), recomputes each candidate's bin coordinate on that axis,
//     clip(trunc((p_w − origin_w) / cell), lo, hi)      (IEEE f32 divide)
// and places those whose coordinate equals its own into its K slots in that
// order. Candidates past K are counted in `dropped`, as are own-cell
// (s = 0) particles whose target lies more than one cell away (no cell
// claims them). Unfilled slots get sentinel positions and zero velocity and
// occupancy. Neighbours outside the array count as empty (they are margins
// in the TPU and plain versions too).
//
// Design: ONE THREAD PER CELL COLUMN (z, c), c fastest, so the K slot
// reads and writes of neighbouring threads coalesce. Stages read one
// buffer set and write a fresh one, never in place. `dropped` is summed
// with one integer atomicAdd per thread that dropped anything: integer
// addition is order-free, so the count is deterministic.
//
// Numerics: no FMA can form (subtract, then divide with __fdiv_rn), and the
// quotient is clamped to [lo, hi] before the conversion: a C cast of an
// out-of-range float (sentinel lanes give ~1e11) is undefined, and for
// integer bounds clamp-then-truncate equals truncate-then-clip.
//
// What bounds it on the H100: memory traffic — each column reads 3K
// occupancy flags and the coordinate of each occupied candidate, and
// writes 7·K floats; ~89% of dam-break slots are empty, so the kernel is a
// bandwidth-bound copy. Left for later: gating empty neighbourhoods (the
// TPU kernel's dilated chunk flags) and fusing the three stages.

#include <cuda_runtime.h>

namespace {

constexpr int kFields = 7;  // px, py, pz, vx, vy, vz, occ
constexpr float kSentinel = 1.0e9f;

struct InFields {
  const float* f[kFields];
};

struct OutFields {
  float* f[kFields];
};

__global__ void rebin_stage_kernel(InFields in, OutFields out, int* dropped,
                                   int n0, int k, int c, int x, int stage,
                                   int axis, float origin, float cell,
                                   int lo, int hi) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n0 * c) return;
  const int z = col / c;
  const int cc = col - z * c;
  const int own = stage == 2 ? cc % x : (stage == 1 ? cc / x : z);
  const int step = stage == 2 ? 1 : x;
  const float* pw = in.f[axis];
  const float* po = in.f[kFields - 1];
  int count = 0;
  int drp = 0;
  for (int s = -1; s <= 1; ++s) {
    const int zs = stage == 0 ? z + s : z;
    const int cs = stage == 0 ? cc : cc + s * step;
    if (zs < 0 || zs >= n0 || cs < 0 || cs >= c) continue;
    for (int ks = 0; ks < k; ++ks) {
      const int j = (zs * k + ks) * c + cs;
      if (!(po[j] > 0.5f)) continue;
      const float q = __fdiv_rn(__fsub_rn(pw[j], origin), cell);
      const int t = static_cast<int>(
          fminf(fmaxf(q, static_cast<float>(lo)), static_cast<float>(hi)));
      if (s == 0 && abs(t - own) > 1) ++drp;
      if (t != own) continue;
      if (count < k) {
        const int o = (z * k + count) * c + cc;
#pragma unroll
        for (int f = 0; f < kFields; ++f) out.f[f][o] = in.f[f][j];
        ++count;
      } else {
        ++drp;
      }
    }
  }
  for (int kk = count; kk < k; ++kk) {
    const int o = (z * k + kk) * c + cc;
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      out.f[f][o] = f < 3 ? kSentinel : 0.0f;
    }
  }
  if (drp) atomicAdd(dropped, drp);
}

constexpr int kThreads = 256;

}  // namespace

// Plain C entry point (loaded with ctypes): `in` and `out` are host arrays
// of 7 device pointers; `dropped` is one device int the stage adds to.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int sph_rebin_stage(const float* const* in, float* const* out,
                               int* dropped, int n0, int k, int c, int x,
                               int stage, int axis, float origin,
                               float cell, int lo, int hi, void* stream) {
  InFields fin;
  OutFields fout;
  for (int f = 0; f < kFields; ++f) {
    fin.f[f] = in[f];
    fout.f[f] = out[f];
  }
  const int cols = n0 * c;
  rebin_stage_kernel<<<(cols + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      fin, fout, dropped, n0, k, c, x, stage, axis, origin, cell, lo, hi);
  return static_cast<int>(cudaGetLastError());
}
