// The adhesion pass's per-bond work for Hopper (sm_90a): A1.
//
// Replaces no Pallas kernel: the JAX package computes the per-bond deltas
// (sph_tpu/physics/adhesion.py `bond_spring_params` and
// `bond_pair_deltas`, :35-121) inside its jitted step, where XLA fuses
// them with the endpoint gathers and the row concatenation. The port ran
// that code eagerly, some 410 launches a step; here it is one kernel:
//
//  A1 `bond_rows_kernel` — per bond: the endpoint slots clamped to the
//     cells, the cells' position, velocity, rotation and mass read at
//     them, the spring parameters of genome mode uid_A % n_modes (the
//     reference's quirk, CellAdhesionManager.cs:537; n_modes read from the
//     device), then the spring, the anchor swing of each endpoint and the
//     relative-orientation correction (SimulateParticles.compute:436-583),
//     zero where the bond is invalid or a gate does not pass. Out: the
//     [Mp, 7] row table the accumulates read (sph_tpu_torch/physics/
//     adhesion.py): row i < B is [Δv_A | Δq_A] of bond i, row B + i
//     [Δv_B | Δq_B], rows 2B..Mp−1 zero.
//
// What it computes: bitwise what the plain version (physics/adhesion.py
// `bond_rows`) computes with eager PyTorch on the card. Every torch op is
// one rounding, written with a rounded intrinsic (`__fadd_rn`,
// `__fmul_rn`, `__fdiv_rn`, `__fsqrt_rn`) that nvcc never contracts into
// an FMA. Where torch's kernels differ from the obvious formula, this
// file follows them:
//   - `torch.sum` over a last dim of 3 (`quat.dot`, `quat.norm`) adds in
//     the reduction's order, (x0 + x2) + x1, from accumulators that start
//     at +0, so a sum of −0s is +0: `t_sum3`.
//   - clamp(min=) returns NaN for NaN, then fmaxf.
//   - sin, cos and atan2 are the CUDA library's sinf, cosf and atan2f,
//     which torch's kernels call for f32.
//   - a tensor times a Python float multiplies by the float rounded to
//     f32 (dt, 10, 5, 2, 0.5).
//
// What bounds it on the H100: memory traffic, and the gathers in it. A
// bond reads its own 53 bytes (slots, uid, flag, two anchors, the rest
// orientation), its two cells' 88 bytes at random slots, and writes two
// 28-byte rows: ~197 B a bond, 340 MB at the 1M colony's 1.725M bonds,
// 0.10 ms at 3.35 TB/s (each endpoint read as whole 32-byte sectors:
// 0.15 ms). Its arithmetic, under a thousand f32 operations a bond with
// four sinf/cosf pairs, one atan2f and a dozen IEEE divisions and square
// roots, is ~1.7 GFLOP a call, 0.03 ms at the f32 rate. The design: one thread
// a bond, the whole chain in registers; the bond's fields read coalesced
// (neighbouring threads, neighbouring bonds), the cells' rows through the
// read-only path (a rotation as one 16-byte load when the table is 16-byte
// aligned); each block stages its 256 bonds' two rows in shared memory
// and stores them as two runs of 7 KB, so a warp's store fills whole
// 128-byte lines; as many blocks as are resident at once walk the bonds
// by block-sized tiles, then write the pad rows.

#include <cuda_runtime.h>

#include <cstdint>

#include "persistent.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 7;  // Δv (3) and Δq (4)

struct Inputs {
  const float* pos;     // [n, 3]
  const float* vel;     // [n, 3]
  const float* rot;     // [n, 4]
  const float* mass;    // [n]
  const int* slot_a;    // [b]
  const int* slot_b;    // [b]
  const uint8_t* active;  // [b] bool
  const int* uid_a;     // [b]
  const float* anchor_a;  // [b, 3]
  const float* anchor_b;  // [b, 3]
  const float* rel;     // [b, 4]
  const int* n_modes;   // 0-dim
  const float* rest;    // [modes]
  const float* stiff;   // [modes]
  const float* damp;    // [modes]
  const float* orient;  // [modes] orientation constraint strength
};

struct V3 {
  float x, y, z;
};
struct Q4 {
  float x, y, z, w;
};

// -- torch's ops, one rounding each -----------------------------------------

__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
// torch.sum over 3: lanes (0, 2) and (1) of the reduction, each from +0.
__device__ __forceinline__ float t_sum3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fadd_rn(a, c), b), 0.f);
}
__device__ __forceinline__ float t_dot(V3 a, V3 b) {
  return t_sum3(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                __fmul_rn(a.z, b.z));
}
__device__ __forceinline__ float t_norm(V3 a) {
  return __fsqrt_rn(t_dot(a, a));
}
__device__ __forceinline__ V3 t_sub(V3 a, V3 b) {
  return {__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z)};
}
__device__ __forceinline__ V3 t_add(V3 a, V3 b) {
  return {__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z)};
}
__device__ __forceinline__ V3 t_div(V3 a, float d) {
  return {__fdiv_rn(a.x, d), __fdiv_rn(a.y, d), __fdiv_rn(a.z, d)};
}
// quat.cross: each component a product minus a product.
__device__ __forceinline__ V3 t_cross(V3 a, V3 b) {
  return {__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
          __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
          __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x))};
}
// quat.rotate: v + 2·(u × (u × v + w·v)).
__device__ __forceinline__ V3 t_rotate(Q4 q, V3 v) {
  const V3 u{q.x, q.y, q.z};
  const V3 c = t_cross(u, v);
  const V3 t{__fadd_rn(c.x, __fmul_rn(q.w, v.x)),
             __fadd_rn(c.y, __fmul_rn(q.w, v.y)),
             __fadd_rn(c.z, __fmul_rn(q.w, v.z))};
  const V3 c2 = t_cross(u, t);
  return {__fadd_rn(v.x, __fmul_rn(c2.x, 2.f)),
          __fadd_rn(v.y, __fmul_rn(c2.y, 2.f)),
          __fadd_rn(v.z, __fmul_rn(c2.z, 2.f))};
}
// quat.mul: v = (w1·v2 + w2·v1) + v1 × v2, w = w1·w2 − v1·v2.
__device__ __forceinline__ Q4 t_qmul(Q4 a, Q4 b) {
  const V3 v1{a.x, a.y, a.z}, v2{b.x, b.y, b.z};
  const V3 c = t_cross(v1, v2);
  return {__fadd_rn(__fadd_rn(__fmul_rn(a.w, b.x), __fmul_rn(b.w, a.x)), c.x),
          __fadd_rn(__fadd_rn(__fmul_rn(a.w, b.y), __fmul_rn(b.w, a.y)), c.y),
          __fadd_rn(__fadd_rn(__fmul_rn(a.w, b.z), __fmul_rn(b.w, a.z)), c.z),
          __fsub_rn(__fmul_rn(a.w, b.w), t_dot(v1, v2))};
}
__device__ __forceinline__ Q4 t_conj(Q4 q) { return {-q.x, -q.y, -q.z, q.w}; }

// _axis_angle_delta: from_axis_angle(axis, angle) ⊗ q − q.
__device__ __forceinline__ Q4 axis_angle_delta(V3 axis, float angle, Q4 q) {
  const float half = __fmul_rn(angle, 0.5f);
  const float s = sinf(half), c = cosf(half);
  const Q4 rq{__fmul_rn(axis.x, s), __fmul_rn(axis.y, s),
              __fmul_rn(axis.z, s), c};
  const Q4 m = t_qmul(rq, q);
  return {__fsub_rn(m.x, q.x), __fsub_rn(m.y, q.y), __fsub_rn(m.z, q.z),
          __fsub_rn(m.w, q.w)};
}

// bond_pair_deltas' swing: the rotation delta that turns the endpoint's
// world anchor r_world toward `desired`, or zero.
__device__ __forceinline__ Q4 swing(Q4 q, V3 r_world, V3 desired,
                                    bool anchor_ok, float strength) {
  const V3 axis = t_cross(r_world, desired);
  const float axis_len = t_norm(axis);
  const V3 axis_n = t_div(axis, t_clamp_min(axis_len, 1e-20f));
  const float eff = fabsf(t_dot(t_cross(axis_n, r_world), desired));
  const bool ok = anchor_ok && axis_len > 1e-6f && eff > 1e-6f;
  if (!ok) return {0.f, 0.f, 0.f, 0.f};
  return axis_angle_delta(axis_n, __fmul_rn(__fmul_rn(strength, eff), 5.f),
                          q);
}

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}
__device__ __forceinline__ Q4 load4(const float* p, int i, bool vec) {
  if (vec) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
    return {f.x, f.y, f.z, f.w};
  }
  return {__ldg(p + 4 * i), __ldg(p + 4 * i + 1), __ldg(p + 4 * i + 2),
          __ldg(p + 4 * i + 3)};
}

// One bond: its two rows, ra ([Δv_A | Δq_A]) and rb.
__device__ __forceinline__ void bond_rows(const Inputs& in, int i, int n,
                                          int n_table, bool anchors_on,
                                          float dt, bool vec_rot,
                                          bool vec_rel, float ra[kRow],
                                          float rb[kRow]) {
  const int sa = in.slot_a[i], sb = in.slot_b[i];
  const bool valid = in.active[i] != 0 && sa >= 0 && sb >= 0;
  const int ia = min(max(sa, 0), n - 1), ib = min(max(sb, 0), n - 1);

  // Spring parameters of mode uid_A % n_modes (torch.remainder: the sign
  // of the divisor), clipped to the modes and to the tables.
  const int nm = max(__ldg(in.n_modes), 1);
  int mode = in.uid_a[i] % nm;
  if (mode != 0 && mode < 0) mode += nm;
  mode = min(min(max(mode, 0), nm - 1), n_table - 1);
  const float rest = __ldg(in.rest + mode);
  const float stiff = __ldg(in.stiff + mode);
  const float damp = __ldg(in.damp + mode);
  const float anchor_stiff = __fmul_rn(__ldg(in.orient + mode), 10.f);

  const V3 pa = load3(in.pos, ia), pb = load3(in.pos, ib);
  const V3 va = load3(in.vel, ia), vb = load3(in.vel, ib);
  const Q4 qa = load4(in.rot, ia, vec_rot), qb = load4(in.rot, ib, vec_rot);
  const float ma = __ldg(in.mass + ia), mb = __ldg(in.mass + ib);

  // Spring (distance) constraint (compute:436-456).
  const V3 delta = t_sub(pb, pa);
  const float dist = t_norm(delta);
  const bool spring_ok = valid && dist > 1e-6f;
  const V3 dirv = t_div(delta, t_clamp_min(dist, 1e-20f));
  const float fs = __fmul_rn(__fsub_rn(dist, rest), stiff);
  const float fd = __fmul_rn(t_dot(t_sub(vb, va), dirv), damp);
  const V3 force{__fadd_rn(__fmul_rn(dirv.x, fs), __fmul_rn(dirv.x, fd)),
                 __fadd_rn(__fmul_rn(dirv.y, fs), __fmul_rn(dirv.y, fd)),
                 __fadd_rn(__fmul_rn(dirv.z, fs), __fmul_rn(dirv.z, fd))};
  ra[0] = spring_ok ? __fmul_rn(__fdiv_rn(force.x, ma), dt) : 0.f;
  ra[1] = spring_ok ? __fmul_rn(__fdiv_rn(force.y, ma), dt) : 0.f;
  ra[2] = spring_ok ? __fmul_rn(__fdiv_rn(force.z, ma), dt) : 0.f;
  rb[0] = spring_ok ? __fmul_rn(__fdiv_rn(-force.x, mb), dt) : 0.f;
  rb[1] = spring_ok ? __fmul_rn(__fdiv_rn(-force.y, mb), dt) : 0.f;
  rb[2] = spring_ok ? __fmul_rn(__fdiv_rn(-force.z, mb), dt) : 0.f;

  // Anchor swing (compute:457-539).
  const bool enabled = valid && anchors_on;
  const float strength = __fmul_rn(anchor_stiff, dt);
  const V3 ra_world = t_rotate(qa, load3(in.anchor_a, i));
  const V3 rb_world = t_rotate(qb, load3(in.anchor_b, i));
  const V3 a_delta = t_sub(t_add(pb, rb_world), t_add(pa, ra_world));
  const float a_dist = t_norm(a_delta);
  const bool anchor_ok = enabled && a_dist > 1e-6f;
  const V3 a_dir = t_div(a_delta, t_clamp_min(a_dist, 1e-20f));
  Q4 dqa = swing(qa, ra_world, a_dir, anchor_ok, strength);
  Q4 dqb = swing(qb, rb_world, V3{-a_dir.x, -a_dir.y, -a_dir.z}, anchor_ok,
                 strength);

  // Relative-orientation constraint (compute:541-583).
  const Q4 cur = t_qmul(t_conj(qa), qb);
  const Q4 corr = t_qmul(load4(in.rel, i, vec_rel), t_conj(cur));
  const V3 corr_v{corr.x, corr.y, corr.z};
  const float corr_len = t_norm(corr_v);
  const float corr_angle = __fmul_rn(atan2f(corr_len, fabsf(corr.w)), 2.f);
  Q4 oa{0.f, 0.f, 0.f, 0.f}, ob{0.f, 0.f, 0.f, 0.f};
  if (enabled && corr_angle > 1e-6f) {
    const V3 axis = t_div(corr_v, t_clamp_min(corr_len, 1e-20f));
    const float o_strength = __fmul_rn(strength, 2.f);
    oa = axis_angle_delta(
        axis, __fmul_rn(__fmul_rn(-o_strength, corr_angle), 0.5f), qa);
    ob = axis_angle_delta(
        axis, __fmul_rn(__fmul_rn(o_strength, corr_angle), 0.5f), qb);
  }
  ra[3] = __fadd_rn(dqa.x, oa.x);
  ra[4] = __fadd_rn(dqa.y, oa.y);
  ra[5] = __fadd_rn(dqa.z, oa.z);
  ra[6] = __fadd_rn(dqa.w, oa.w);
  rb[3] = __fadd_rn(dqb.x, ob.x);
  rb[4] = __fadd_rn(dqb.y, ob.y);
  rb[5] = __fadd_rn(dqb.z, ob.z);
  rb[6] = __fadd_rn(dqb.w, ob.w);
}

__global__ void __launch_bounds__(kThreads)
    bond_rows_kernel(Inputs in, float* __restrict__ out, int n, int b,
                     int rows, int n_table, int anchors_on, float dt,
                     int vec_rot, int vec_rel) {
  __shared__ float stage_a[kThreads * kRow];
  __shared__ float stage_b[kThreads * kRow];
  const int tiles = (b + kThreads - 1) / kThreads;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int first = t * kThreads;
    const int i = first + threadIdx.x;
    if (i < b) {
      float ra[kRow], rb[kRow];
      bond_rows(in, i, n, n_table, anchors_on != 0, dt, vec_rot != 0,
                vec_rel != 0, ra, rb);
      // A stride of 7 words: the 32 lanes hit 32 banks.
#pragma unroll
      for (int k = 0; k < kRow; ++k) {
        stage_a[threadIdx.x * kRow + k] = ra[k];
        stage_b[threadIdx.x * kRow + k] = rb[k];
      }
    }
    __syncthreads();
    const int count = min(kThreads, b - first) * kRow;
    float* out_a = out + first * kRow;
    float* out_b = out + (b + first) * kRow;
    for (int j = threadIdx.x; j < count; j += kThreads) {
      out_a[j] = stage_a[j];
      out_b[j] = stage_b[j];
    }
    __syncthreads();
  }
  const int stride = gridDim.x * kThreads;
  for (int j = 2 * b * kRow + blockIdx.x * kThreads + threadIdx.x;
       j < rows * kRow; j += stride) {
    out[j] = 0.f;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// A1. `ptrs` (host, 16 device pointers): pos, vel, rot, mass, slot_a,
// slot_b, active, uid_a, anchor_a, anchor_b, rel_orientation, n_modes,
// and the genome's rest length, spring stiffness, spring damping and
// orientation constraint strength tables (n_table entries each). `out`:
// the [rows, 7] table, fresh; rows ≥ 2b, rows·7 < 2^31. n ≥ 1 cells,
// b ≥ 0 bonds.
extern "C" int sph_bond_rows(const void* const* ptrs, float* out, int n,
                             int b, int rows, int n_table, int anchors_on,
                             float dt, int device, void* stream) {
  if (n < 1 || b < 0 || n_table < 1 || rows < 2 * b ||
      static_cast<long long>(rows) * kRow >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Inputs in;
  in.pos = static_cast<const float*>(ptrs[0]);
  in.vel = static_cast<const float*>(ptrs[1]);
  in.rot = static_cast<const float*>(ptrs[2]);
  in.mass = static_cast<const float*>(ptrs[3]);
  in.slot_a = static_cast<const int*>(ptrs[4]);
  in.slot_b = static_cast<const int*>(ptrs[5]);
  in.active = static_cast<const uint8_t*>(ptrs[6]);
  in.uid_a = static_cast<const int*>(ptrs[7]);
  in.anchor_a = static_cast<const float*>(ptrs[8]);
  in.anchor_b = static_cast<const float*>(ptrs[9]);
  in.rel = static_cast<const float*>(ptrs[10]);
  in.n_modes = static_cast<const int*>(ptrs[11]);
  in.rest = static_cast<const float*>(ptrs[12]);
  in.stiff = static_cast<const float*>(ptrs[13]);
  in.damp = static_cast<const float*>(ptrs[14]);
  in.orient = static_cast<const float*>(ptrs[15]);
  int resident = 0;
  const cudaError_t rc = sph::persistent_grid(
      reinterpret_cast<const void*>(bond_rows_kernel), kThreads, 0, device,
      &resident);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // A block a tile of bonds, at most the resident ones; the pad rows are
  // written by the same blocks after their tiles.
  const int need = (b + kThreads - 1) / kThreads;
  const int grid = need < 1 ? 1 : (need < resident ? need : resident);
  bond_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, n, b, rows, n_table, anchors_on, dt,
      aligned16(in.rot) ? 1 : 0, aligned16(in.rel) ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
