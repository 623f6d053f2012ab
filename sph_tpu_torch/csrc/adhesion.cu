// The adhesion pass's per-bond work for Hopper (sm_90a): A1, the per-bond
// rows, and A2, the planned accumulate of those rows per particle (its
// note is below A1's code).
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

// -- A2: the planned accumulate ----------------------------------------------
//
// Replaces no Pallas kernel either: XLA fuses the JAX package's
// `_blocked_segscan` and the gathers around it (sph_tpu/physics/
// adhesion.py `accumulate_bond_deltas_planned`) inside its jitted step; the
// port ran them as ~170 eager launches. Given the [Mp, 7] row table, a bond
// plan (perm, flags, last, has) and an optional zero_bond mask [b], A2
// gives each particle's [Δv | Δq], bitwise what sph_tpu_torch/physics/
// adhesion.py `accumulate_bond_deltas_planned` gives with eager PyTorch:
// the same tree of adds as `_blocked_segscan`, level by level, every add
// one `__fadd_rn` (no multiply, so nothing to contract), the +0 that
// `F.pad` shifts in and the leading +0 of the block prefixes added as the
// plain code adds them (−0 + +0 is +0), a select where it selects, so a
// NaN row spreads as it does there. Two launches:
//
//  1. `scan_blocks_kernel`, one block of kSegW threads a scan block of
//     kSegW rows (`_SEG_W`), a thread a row: the row rows[perm[j]], zero
//     where its bond is in zero_bond (row i < b is bond i's, row b + i
//     too, the rest no bond's), and flags[j]; the in-block Hillis-Steele
//     in shared memory, d = 1, 2, ..., kSegW/2: v = f ? v : v + v[j − d]
//     (+0 before the block), f = f | f[j − d]. The block's total (its last
//     row) goes to the totals, [7][mb] by component, and the in-block
//     value and flag of every row that ends a run (the next flag set, or
//     the last row) to v_in / f_in: `last` points only at such rows.
//  2. `scan_finish_kernel`. Its first kRow blocks to run (a ticket from
//     the stream's cursor) each scan one component of the mb block totals
//     by the same levels, between two buffers in device memory (any mb),
//     and count themselves ready. Every other block takes kFinish
//     particles, reads what needs no prefix, waits for the kRow ready
//     counts (blocks that wait hold tickets after the scanning ones, which
//     are running, so the wait ends), then gives each particle has ?
//     (f_in[j] ? v_in[j] : v_in[j] + pre) : +0, with j = last, pre the
//     scanned total of the block before j's (+0 for the first); staged in
//     shared memory and stored as one run of whole lines a block. The last
//     block to finish leaves the cursor zeroed.
//
// What bounds it on the H100: memory traffic. At the 1M colony (Mp =
// 3,637,248 rows, mb = 7,104, n = 1,048,576) the row gather reads 102 MB
// (204 MB as whole 32-byte sectors: a 28-byte row spans two sectors
// three times in four), perm 29 MB, flags 4 MB, last and has 9 MB, and
// the [n, 7] result writes 29 MB: ~173 MB, 0.05 ms at 3.35 TB/s, ~0.09 ms
// by sectors. The run ends (~1M rows of 28 B) go out and come back once.
// The in-block levels cost 9 barriers a block; the totals' ~13 levels
// run in 7 blocks, in L2, while the other blocks load their particles.

constexpr int kSegW = 512;     // _SEG_W: rows a scan block
constexpr int kFinish = 1024;  // threads (particles) a finishing block

__global__ void __launch_bounds__(kSegW)
    scan_blocks_kernel(const float* __restrict__ rows,
                       const long long* __restrict__ perm,
                       const uint8_t* __restrict__ flags,
                       const uint8_t* __restrict__ zero_bond, int b, int mp,
                       int mb, float* __restrict__ v_in,
                       uint8_t* __restrict__ f_in, float* __restrict__ tv,
                       uint8_t* __restrict__ tf) {
  __shared__ float sv[2][kRow][kSegW];
  __shared__ uint8_t sf[2][kSegW];
  const int t = threadIdx.x;
  const int j = blockIdx.x * kSegW + t;
  const int p = static_cast<int>(perm[j]);
  bool zero = false;
  if (zero_bond != nullptr && p < 2 * b) {
    zero = zero_bond[p < b ? p : p - b] != 0;
  }
  float v[kRow];
#pragma unroll
  for (int k = 0; k < kRow; ++k) {
    v[k] = zero ? 0.f : __ldg(rows + p * kRow + k);
  }
  bool f = flags[j] != 0;
  int cur = 0;
#pragma unroll
  for (int d = 1; d < kSegW; d *= 2) {
#pragma unroll
    for (int k = 0; k < kRow; ++k) sv[cur][k][t] = v[k];
    sf[cur][t] = f;
    __syncthreads();
    // The level reads the old values: the pad's (+0, false) before the
    // block.
    const bool in = t >= d;
    const bool fs = in && sf[cur][t - d] != 0;
#pragma unroll
    for (int k = 0; k < kRow; ++k) {
      const float s = in ? sv[cur][k][t - d] : 0.f;
      v[k] = f ? v[k] : __fadd_rn(v[k], s);
    }
    f = f || fs;
    cur ^= 1;  // the next level writes the other buffer: one barrier
  }
  if (t == kSegW - 1) {
#pragma unroll
    for (int k = 0; k < kRow; ++k) tv[k * mb + blockIdx.x] = v[k];
    tf[blockIdx.x] = f;
  }
  if (j == mp - 1 || flags[j + 1] != 0) {
#pragma unroll
    for (int k = 0; k < kRow; ++k) v_in[j * kRow + k] = v[k];
    f_in[j] = f;
  }
}

// The scan of component k's block totals by one block: level by level,
// from the totals (tv[0][k], flags tf[0]) between two buffers of its own
// (tv[0][k] and tv[1][k]; flags tf[1 + 2k] and tf[2 + 2k], never tf[0],
// which every component reads). After `levels` levels the scanned totals
// are in tv[levels % 2][k].
__device__ void scan_totals(float* tv, uint8_t* tf, int k, int mb,
                            int levels) {
  float* v_buf[2] = {tv + k * mb, tv + (kRow + k) * mb};
  uint8_t* f_buf[2] = {tf + (1 + 2 * k) * mb, tf + (2 + 2 * k) * mb};
  const uint8_t* f_src = tf;
  int src = 0;
  for (int level = 0, d = 1; level < levels; ++level, d *= 2) {
    const float* v = v_buf[src];
    float* v_dst = v_buf[1 - src];
    uint8_t* f_dst = f_buf[src];
    for (int i = threadIdx.x; i < mb; i += kFinish) {
      const bool in = i >= d;
      const bool f = f_src[i] != 0;
      const float s = in ? v[i - d] : 0.f;
      v_dst[i] = f ? v[i] : __fadd_rn(v[i], s);
      f_dst[i] = f || (in && f_src[i - d] != 0);
    }
    __syncthreads();  // the level's writes, seen by the block's next level
    f_src = f_dst;
    src = 1 - src;
  }
}

__global__ void __launch_bounds__(kFinish)
    scan_finish_kernel(const float* __restrict__ v_in,
                       const uint8_t* __restrict__ f_in, float* tv,
                       uint8_t* tf, const long long* __restrict__ last,
                       const uint8_t* __restrict__ has, int n, int mb,
                       int roles, int* cursor, float* __restrict__ out) {
  __shared__ float stage[kFinish * kRow];
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(cursor, 1);
  __syncthreads();
  int levels = 0;
  while ((1 << levels) < mb) ++levels;
  if (ticket < roles) {
    scan_totals(tv, tf, ticket, mb, levels);
    __threadfence();  // every thread's scanned totals before the ready count
    __syncthreads();
    if (threadIdx.x == 0 &&
        atomicAdd(cursor + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      cursor[0] = 0;
      cursor[1] = 0;
    }
    return;
  }
  const int first = (ticket - roles) * kFinish;
  const int i = first + threadIdx.x;
  float r[kRow];
  int blk = 0;
  bool add = false;
#pragma unroll
  for (int k = 0; k < kRow; ++k) r[k] = 0.f;
  if (i < n && has[i] != 0) {
    const int j = static_cast<int>(last[i]);
    blk = j / kSegW;
    add = f_in[j] == 0;
#pragma unroll
    for (int k = 0; k < kRow; ++k) r[k] = v_in[j * kRow + k];
  }
  if (threadIdx.x == 0) {
    while (*reinterpret_cast<volatile int*>(cursor + 1) < roles) {
      __nanosleep(128);
    }
    __threadfence();
  }
  __syncthreads();
  if (add) {
    // The scanned totals sit in the buffer the last level wrote; read
    // them from L2, where the scanning blocks left them.
    const float* pre = tv + ((levels & 1) ? kRow * mb : 0);
#pragma unroll
    for (int k = 0; k < kRow; ++k) {
      const float p = blk == 0 ? 0.f : __ldcg(pre + k * mb + blk - 1);
      r[k] = __fadd_rn(r[k], p);
    }
  }
  if (i < n) {
#pragma unroll
    for (int k = 0; k < kRow; ++k) stage[threadIdx.x * kRow + k] = r[k];
  }
  __syncthreads();
  const int count = min(kFinish, n - first) * kRow;
  for (int e = threadIdx.x; e < count; e += kFinish) {
    out[first * kRow + e] = stage[e];
  }
  if (threadIdx.x == 0 &&
      atomicAdd(cursor + 1, 1) == static_cast<int>(gridDim.x) - 1) {
    cursor[0] = 0;
    cursor[1] = 0;
  }
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

// A2. rows [mp, 7]; perm [mp] and last [n] int64; flags [mp] and has [n]
// bool; zero_bond [b] bool or null (2b ≤ mp); out [n, 7]. Scratch, all
// fresh: v_in [mp, 7], f_in [mp], tv [2][7][mb] and tf [15][mb] (mb = mp
// / 512). `cursor`: two int32 zeros of the stream, left zeroed. mp a
// multiple of 512, at least 512, mp·7 and n·7 < 2^31.
extern "C" int sph_bond_scan(const float* rows, const long long* perm,
                             const uint8_t* flags, const long long* last,
                             const uint8_t* has, const uint8_t* zero_bond,
                             int b, float* out, float* v_in, uint8_t* f_in,
                             float* tv, uint8_t* tf, int* cursor, int mp,
                             int n, void* stream) {
  if (mp < kSegW || mp % kSegW != 0 || n < 0 || b < 0 || b > mp / 2 ||
      static_cast<long long>(mp) * kRow >= (1ll << 31) ||
      static_cast<long long>(n) * kRow >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mb = mp / kSegW;
  scan_blocks_kernel<<<mb, kSegW, 0, s>>>(rows, perm, flags, zero_bond, b,
                                          mp, mb, v_in, f_in, tv, tf);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // One block a component scans the totals where there are two or more.
  const int roles = mb > 1 ? kRow : 0;
  const int grid = roles + (n + kFinish - 1) / kFinish;
  if (grid > 0) {
    scan_finish_kernel<<<grid, kFinish, 0, s>>>(v_in, f_in, tv, tf, last,
                                                has, n, mb, roles, cursor,
                                                out);
  }
  return static_cast<int>(cudaGetLastError());
}
