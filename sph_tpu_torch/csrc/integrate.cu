// The dense step's per-slot tail for Hopper (sm_90a): F1 and F2.
//
// Replaces no Pallas kernel: the JAX package's step is one jitted scan
// (sph_tpu/sph/dense.py `make_dense_step`), and XLA fuses the per-slot
// code between its Pallas calls into a few loop fusions. The port runs
// that code eagerly, one launch and one pass over the layout per torch op,
// so the same code becomes two kernels here:
//
//  F1 `integrate_kernel` — `_integrate` (sph_tpu/sph/dense.py:460; the
//     port's plain version sph_tpu_torch/sph/dense.py `_integrate`):
//     gravity, the SDF obstacles' penalty push (sph/model.py
//     `obstacle_accel`, `sdf_value_grad`: sphere, box, cylinder_z), the
//     optional interactive drag (`FluidDrag`, read from its device
//     tensors), symplectic Euler masked by occupancy with the velocity
//     clamped to the rebin budget vmax before the position update, the
//     count of clamped slots, the count of pushed slots (occupied, with a
//     positive penetration of some obstacle: within h/2 of its surface;
//     once a slot), and the box walls with damping (no z wall and vz =
//     vz·0 in 2D). In: px, py, pz, vx, vy, vz, ax, ay, az, occ; out: the
//     six moved planes and `counts` (int32 clamped, pushed; added to).
//  F2 `density_tail_kernel` — the lines of `dense_step` between the two
//     pair sweeps (sph_tpu/sph/dense.py:682-687): the density fixup
//     (`density_fixup`), the Tait EOS masked by occupancy (`eos_pressure`)
//     and p/ρ², the operand K2 takes. In: K1's raw ρ and occ; out: ρ, p
//     and p/ρ².
//
// What it computes: bitwise what the plain version computes with eager
// PyTorch on the card, on finite inputs, and NaN where it gives NaN. Every
// torch op is one rounding, so each is written out with a rounded
// intrinsic (`__fadd_rn`, `__fmul_rn`, `__fdiv_rn`, `__fsqrt_rn`), which
// nvcc never contracts into an FMA. Where torch's own kernels differ from
// the obvious formula, this file follows them:
//   - a tensor divided by a Python float is multiplied by the reciprocal
//     torch forms on the host (`div_true_kernel_cuda` with a CPU scalar):
//     1/x of the double x, rounded to f32 (measured on the card: not the
//     f32 quotient 1/f32(x)). So ρ / ρ₀ and strength / mass are products
//     with the 1/ρ₀ and 1/m the wrapper passes. A 0-dim tensor divisor
//     (vmax / speed) divides once.
//   - `torch.linalg.vector_norm` over the last dim of 2 or 3 squares each
//     component in its own accumulator (one rounding each, the thread's
//     fma into 0) and sums them in the reduction's order: x² + y², and
//     (x² + z²) + y² — two lanes of a block-x reduction, lane 0 holding
//     components 0 and 2.
//   - clamp, clamp_min and clamp_max return NaN for NaN (CUDA's fmaxf and
//     fminf return the other operand), then fmaxf / fminf as torch does.
//   - `torch.sign` is (0 < a) − (a < 0): 0 for NaN and ±0.
//   - `amax` keeps NaN; `argmax` is the first index of the maximum, NaN
//     first.
//   - `(ρ/ρ₀) ** γ` is torch's general `pow` for γ ∉ {0, ±½, 1, ±1, 2, 3,
//     −2}: powf(x, γ) with γ at run time, as torch's kernel has it.
//   - `zeros + term` turns −0 into +0 (the obstacles' sum starts from 0),
//     and `ay − g` and `ax + push` are roundings of their own.
// Python floats enter as f32, rounded by the wrapper as torch rounds its
// scalars.
//
// What bounds it on the H100: memory traffic. F1 reads 10 planes and
// writes 6 (16 · 35.6 MB = 570 MB at config[3]'s [145, 8, 7680]: 0.170 ms
// at 3.35 TB/s); F2 reads 2 and writes 3 (178 MB, 0.053 ms). Its
// operations (a few dozen a slot; pow and the obstacles' square roots and
// divisions) are ~10× below the f32 rate. The design: one grid-stride pass,
// four slots a thread as one 16-byte load or store per plane (a scalar
// pass when a pointer is not 16-byte aligned, and for the last n mod 4
// slots), as many blocks as are resident at once; no shared memory but
// the warp sums of the two counts, one integer atomicAdd a count and block
// (integer addition is order-free, so the counts are deterministic).

#include <cuda_runtime.h>

#include <cstdint>

#include "persistent.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxObstacles = 8;
constexpr int kSphere = 0, kBox = 1, kCylinderZ = 2;

// The obstacles (`params.obstacles`), in order: kind, centre (a cylinder
// uses two coordinates), and extent (sphere and cylinder: the radius;
// box: the half extents).
struct Obstacles {
  int n;
  int kind[kMaxObstacles];
  float c[kMaxObstacles][3];
  float e[kMaxObstacles][3];
};

// F1's scalars, as f32: the host layout of `consts` in `sph_integrate`.
struct Consts {
  float dt, gravity, vmax, neg_damping, half_h, stiffness, inv_mass;
  float lo[3], hi[3];
};
constexpr int kConsts = 13;

// The drag's device tensors (center [3], radius, target [3], strength),
// or all null.
struct Drag {
  const float* center;
  const float* radius;
  const float* target;
  const float* strength;
};

struct Ins {
  const float* p[10];  // px, py, pz, vx, vy, vz, ax, ay, az, occ
};
struct Outs {
  float* p[6];  // px, py, pz, vx, vy, vz
};

// F2's scalars: ρ floor, ρ₀, 1/ρ₀, γ, the Tait B.
struct TailConsts {
  float rho_floor, rest, inv_rest, gamma, tait_b;
};
constexpr int kTailConsts = 5;

// -- torch's elementwise ops, one rounding each -----------------------------

__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float t_clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float t_clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float t_sign(float a) {
  return static_cast<float>((0.f < a) - (a < 0.f));
}
__device__ __forceinline__ float t_norm2(float a, float b) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
}
__device__ __forceinline__ float t_norm3(float a, float b, float c) {
  return __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(c, c)), __fmul_rn(b, b)));
}
// amax's combine: NaN wins.
__device__ __forceinline__ float t_max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}
// argmax over 3: the first index of the maximum, the first NaN first.
__device__ __forceinline__ int t_argmax3(float q0, float q1, float q2) {
  int best = 0;
  float b = q0;
  if (isnan(q1) ? !isnan(b) : (!isnan(b) && q1 > b)) {
    best = 1;
    b = q1;
  }
  if (isnan(q2) ? !isnan(b) : (!isnan(b) && q2 > b)) best = 2;
  return best;
}

// The obstacles' penalty acceleration at one position (`obstacle_accel`);
// returns whether some obstacle's penetration is positive (its push acts).
__device__ __forceinline__ bool obstacle_push(const Obstacles& ob,
                                              float half_h, float stiffness,
                                              float px, float py, float pz,
                                              float acc[3]) {
  acc[0] = acc[1] = acc[2] = 0.f;
  bool band = false;
  // Unrolled, so that every index into the parameter is a constant.
#pragma unroll
  for (int i = 0; i < kMaxObstacles; ++i) {
    if (i >= ob.n) break;
    const float* c = ob.c[i];
    const float* e = ob.e[i];
    float sd, n0, n1, n2;
    if (ob.kind[i] == kSphere) {
      const float dx = __fsub_rn(px, c[0]), dy = __fsub_rn(py, c[1]),
                  dz = __fsub_rn(pz, c[2]);
      const float dist = t_norm3(dx, dy, dz);
      const float den = t_clamp_min(dist, 1e-9f);
      sd = __fsub_rn(dist, e[0]);
      n0 = __fdiv_rn(dx, den);
      n1 = __fdiv_rn(dy, den);
      n2 = __fdiv_rn(dz, den);
    } else if (ob.kind[i] == kBox) {
      const float dx = __fsub_rn(px, c[0]), dy = __fsub_rn(py, c[1]),
                  dz = __fsub_rn(pz, c[2]);
      const float qx = __fsub_rn(fabsf(dx), e[0]),
                  qy = __fsub_rn(fabsf(dy), e[1]),
                  qz = __fsub_rn(fabsf(dz), e[2]);
      const float ox = t_clamp_min(qx, 0.f), oy = t_clamp_min(qy, 0.f),
                  oz = t_clamp_min(qz, 0.f);
      const float dist_out = t_norm3(ox, oy, oz);
      const float dist_in =
          t_clamp_max(t_max_nan(t_max_nan(qx, qz), qy), 0.f);
      sd = __fadd_rn(dist_out, dist_in);
      const float sx = t_sign(dx), sy = t_sign(dy), sz = t_sign(dz);
      if (dist_out > 0.f) {
        const float den = t_clamp_min(dist_out, 1e-9f);
        n0 = __fdiv_rn(__fmul_rn(sx, ox), den);
        n1 = __fdiv_rn(__fmul_rn(sy, oy), den);
        n2 = __fdiv_rn(__fmul_rn(sz, oz), den);
      } else {
        const int am = t_argmax3(qx, qy, qz);
        n0 = __fmul_rn(sx, am == 0 ? 1.f : 0.f);
        n1 = __fmul_rn(sy, am == 1 ? 1.f : 0.f);
        n2 = __fmul_rn(sz, am == 2 ? 1.f : 0.f);
      }
    } else {  // kCylinderZ: infinite along z
      const float dx = __fsub_rn(px, c[0]), dy = __fsub_rn(py, c[1]);
      const float dist = t_norm2(dx, dy);
      const float den = t_clamp_min(dist, 1e-9f);
      sd = __fsub_rn(dist, e[0]);
      n0 = __fdiv_rn(dx, den);
      n1 = __fdiv_rn(dy, den);
      n2 = 0.f;
    }
    const float pen = t_clamp_min(__fsub_rn(half_h, sd), 0.f);
    const float k = __fmul_rn(pen, stiffness);
    band = band || pen > 0.f;
    acc[0] = __fadd_rn(acc[0], __fmul_rn(n0, k));
    acc[1] = __fadd_rn(acc[1], __fmul_rn(n1, k));
    acc[2] = __fadd_rn(acc[2], __fmul_rn(n2, k));
  }
  return band;
}

// The drag's scalars, formed once a thread as torch forms them (0-dim ops).
struct DragVals {
  bool on;  // a drag was given
  float cx, cy, cz, tx, ty, tz, r2, sg;
  bool live;  // strength > 0
};

__device__ __forceinline__ DragVals load_drag(const Drag& dg,
                                              float inv_mass) {
  DragVals v{};
  v.on = dg.center != nullptr;
  if (!v.on) return v;
  v.cx = __ldg(dg.center);
  v.cy = __ldg(dg.center + 1);
  v.cz = __ldg(dg.center + 2);
  v.tx = __ldg(dg.target);
  v.ty = __ldg(dg.target + 1);
  v.tz = __ldg(dg.target + 2);
  const float r = __ldg(dg.radius), s = __ldg(dg.strength);
  v.r2 = __fmul_rn(r, r);
  v.sg = __fmul_rn(s, inv_mass);
  v.live = s > 0.f;
  return v;
}

// One slot of `_integrate`; adds 1 to `clamped` when the vmax clamp
// limited it and 1 to `pushed` when an obstacle's push acted on it.
__device__ __forceinline__ void integrate_slot(
    const Consts& k, const Obstacles& ob, const DragVals& dg, bool three_d,
    float px, float py, float pz, float vx, float vy, float vz, float ax,
    float ay, float az, float occv, float out[6], int& clamped,
    int& pushed) {
  const bool occ = occv > 0.5f;
  ay = __fsub_rn(ay, k.gravity);
  if (ob.n > 0) {
    float oa[3];
    const bool band =
        obstacle_push(ob, k.half_h, k.stiffness, px, py, pz, oa);
    pushed += (occ && band) ? 1 : 0;
    ax = __fadd_rn(ax, oa[0]);
    ay = __fadd_rn(ay, oa[1]);
    az = __fadd_rn(az, oa[2]);
  }
  if (dg.on) {
    const float ddx = __fsub_rn(px, dg.cx), ddy = __fsub_rn(py, dg.cy),
                ddz = __fsub_rn(pz, dg.cz);
    const float r2 = __fadd_rn(
        __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)),
        __fmul_rn(ddz, ddz));
    const float in_r = (r2 < dg.r2 && dg.live) ? 1.f : 0.f;
    const float g = __fmul_rn(in_r, dg.sg);
    ax = __fadd_rn(ax, __fmul_rn(__fsub_rn(dg.tx, px), g));
    ay = __fadd_rn(ay, __fmul_rn(__fsub_rn(dg.ty, py), g));
    az = __fadd_rn(az, __fmul_rn(__fsub_rn(dg.tz, pz), g));
  }
  float v[3];
  v[0] = occ ? __fadd_rn(vx, __fmul_rn(ax, k.dt)) : 0.f;
  v[1] = occ ? __fadd_rn(vy, __fmul_rn(ay, k.dt)) : 0.f;
  v[2] = three_d ? (occ ? __fadd_rn(vz, __fmul_rn(az, k.dt)) : 0.f)
                 : __fmul_rn(vz, 0.f);
  const float speed = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])),
      __fmul_rn(v[2], v[2])));
  const float scale =
      t_clamp_max(__fdiv_rn(k.vmax, t_clamp_min(speed, 1e-12f)), 1.f);
  clamped += (occ && speed > k.vmax) ? 1 : 0;
  const float p0[3] = {px, py, pz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v[a] = __fmul_rn(v[a], scale);
    float p = occ ? __fadd_rn(p0[a], __fmul_rn(v[a], k.dt)) : p0[a];
    if (a < 2 || three_d) {
      const bool hit = occ && (p < k.lo[a] || p > k.hi[a]);
      if (occ) p = t_clamp(p, k.lo[a], k.hi[a]);
      if (hit) v[a] = __fmul_rn(v[a], k.neg_damping);
    }
    out[a] = p;
    out[3 + a] = v[a];
  }
}

// The block's counts (clamped, pushed): warp sums, then one atomic a count
// and block.
__device__ __forceinline__ void add_block_count(const int count[2],
                                                int* totals) {
  __shared__ int warp_sums[2][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int s = __reduce_add_sync(0xffffffffu, count[c]);
    if (lane == 0) warp_sums[c][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int s = lane < kThreads / 32 ? warp_sums[c][lane] : 0;
      s = __reduce_add_sync(0xffffffffu, s);
      if (lane == 0 && s != 0) atomicAdd(totals + c, s);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    integrate_kernel(Ins in, Outs out, int* counts, int n, int three_d,
                     Consts k, Obstacles ob, Drag drag) {
  const DragVals dg = load_drag(drag, k.inv_mass);
  const int stride = gridDim.x * kThreads;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  int count[2] = {0, 0};  // clamped, pushed
  int tail = 0;
  if (kVec) {
    const int n4 = n >> 2;
    tail = n4 << 2;
    for (int i = tid; i < n4; i += stride) {
      float4 f[10];
#pragma unroll
      for (int j = 0; j < 10; ++j) {
        f[j] = __ldg(reinterpret_cast<const float4*>(in.p[j]) + i);
      }
      float o[4][6];
#define SPH_LANE(L, c)                                                     \
  integrate_slot(k, ob, dg, three_d, f[0].c, f[1].c, f[2].c, f[3].c, f[4].c, \
                 f[5].c, f[6].c, f[7].c, f[8].c, f[9].c, o[L], count[0],     \
                 count[1])
      SPH_LANE(0, x);
      SPH_LANE(1, y);
      SPH_LANE(2, z);
      SPH_LANE(3, w);
#undef SPH_LANE
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        reinterpret_cast<float4*>(out.p[j])[i] =
            make_float4(o[0][j], o[1][j], o[2][j], o[3][j]);
      }
    }
  }
  for (int i = tail + tid; i < n; i += stride) {
    float o[6];
    integrate_slot(k, ob, dg, three_d, in.p[0][i], in.p[1][i], in.p[2][i],
                   in.p[3][i], in.p[4][i], in.p[5][i], in.p[6][i], in.p[7][i],
                   in.p[8][i], in.p[9][i], o, count[0], count[1]);
#pragma unroll
    for (int j = 0; j < 6; ++j) out.p[j][i] = o[j];
  }
  add_block_count(count, counts);
}

// One slot of the density tail: (ρ, p, p/ρ²).
__device__ __forceinline__ void tail_slot(const TailConsts& t, float raw,
                                          float occv, float& rho, float& prs,
                                          float& pr2) {
  const bool occ = occv > 0.5f;
  rho = occ ? t_clamp_min(raw, t.rho_floor) : t.rest;
  const float x = powf(__fmul_rn(rho, t.inv_rest), t.gamma);
  const float p = t_clamp_min(__fmul_rn(t.tait_b, __fsub_rn(x, 1.f)), 0.f);
  prs = occ ? p : 0.f;
  pr2 = __fdiv_rn(prs, __fmul_rn(rho, rho));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    density_tail_kernel(const float* __restrict__ raw,
                        const float* __restrict__ occ,
                        float* __restrict__ rho, float* __restrict__ prs,
                        float* __restrict__ pr2, int n, TailConsts t) {
  const int stride = gridDim.x * kThreads;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  int tail = 0;
  if (kVec) {
    const int n4 = n >> 2;
    tail = n4 << 2;
    for (int i = tid; i < n4; i += stride) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(raw) + i);
      const float4 o = __ldg(reinterpret_cast<const float4*>(occ) + i);
      float4 a, b, c;
      tail_slot(t, r.x, o.x, a.x, b.x, c.x);
      tail_slot(t, r.y, o.y, a.y, b.y, c.y);
      tail_slot(t, r.z, o.z, a.z, b.z, c.z);
      tail_slot(t, r.w, o.w, a.w, b.w, c.w);
      reinterpret_cast<float4*>(rho)[i] = a;
      reinterpret_cast<float4*>(prs)[i] = b;
      reinterpret_cast<float4*>(pr2)[i] = c;
    }
  }
  for (int i = tail + tid; i < n; i += stride) {
    tail_slot(t, raw[i], occ[i], rho[i], prs[i], pr2[i]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// Blocks of a grid-stride pass over n slots: enough for one group of
// four a thread, at most as many as are resident at once.
template <typename Kernel>
cudaError_t grid_of(Kernel kernel, int n, int device, int* grid) {
  int resident = 0;
  const cudaError_t rc = sph::persistent_grid(
      reinterpret_cast<const void*>(kernel), kThreads, 0, device, &resident);
  if (rc != cudaSuccess) return rc;
  const int need = (n / 4 + kThreads - 1) / kThreads;
  *grid = need < 1 ? 1 : (need < resident ? need : resident);
  return cudaSuccess;
}

}  // namespace

// F1. `in` holds 10 device pointers (px, py, pz, vx, vy, vz, ax, ay, az,
// occ), `out` 6 (px, py, pz, vx, vy, vz), fresh; `counts` two int32 the
// kernel adds the clamped and the pushed slots to. `consts` (host, kConsts
// floats): dt, gravity, vmax, −damping, h/2, stiffness, 1/mass, lo[3],
// hi[3]. `kinds` and `geometry` (host): the obstacles' kinds and 6 floats
// each (centre, extent). `drag` (host array of 4 device pointers: center,
// radius, target, strength) or null.
extern "C" int sph_integrate(const float* const* in, float* const* out,
                             int* counts, int n, int ndim,
                             const float* consts, int n_obstacles,
                             const int* kinds, const float* geometry,
                             const float* const* drag, int device,
                             void* stream) {
  if (n < 1 || (ndim != 2 && ndim != 3) || n_obstacles < 0 ||
      n_obstacles > kMaxObstacles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ins ins;
  Outs outs;
  bool vec = true;
  for (int j = 0; j < 10; ++j) {
    ins.p[j] = in[j];
    vec = vec && aligned16(in[j]);
  }
  for (int j = 0; j < 6; ++j) {
    outs.p[j] = out[j];
    vec = vec && aligned16(out[j]);
  }
  Consts k;
  const float* s = consts;
  k.dt = s[0];
  k.gravity = s[1];
  k.vmax = s[2];
  k.neg_damping = s[3];
  k.half_h = s[4];
  k.stiffness = s[5];
  k.inv_mass = s[6];
  for (int a = 0; a < 3; ++a) {
    k.lo[a] = s[7 + a];
    k.hi[a] = s[10 + a];
  }
  static_assert(kConsts == 13, "consts layout");
  Obstacles ob{};
  ob.n = n_obstacles;
  for (int i = 0; i < n_obstacles; ++i) {
    if (kinds[i] != kSphere && kinds[i] != kBox && kinds[i] != kCylinderZ) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    ob.kind[i] = kinds[i];
    for (int a = 0; a < 3; ++a) {
      ob.c[i][a] = geometry[6 * i + a];
      ob.e[i][a] = geometry[6 * i + 3 + a];
    }
  }
  Drag dg{nullptr, nullptr, nullptr, nullptr};
  if (drag != nullptr) dg = Drag{drag[0], drag[1], drag[2], drag[3]};
  auto kernel = vec ? integrate_kernel<true> : integrate_kernel<false>;
  int grid = 0;
  const cudaError_t rc = grid_of(kernel, n, device, &grid);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ins, outs, counts, n, ndim == 3 ? 1 : 0, k, ob, dg);
  return static_cast<int>(cudaGetLastError());
}

// F2. `raw`, `occ` in; `rho`, `prs`, `pr2` out, fresh. `consts` (host,
// kTailConsts floats): ρ floor, ρ₀, 1/ρ₀, γ, Tait B.
extern "C" int sph_density_tail(const float* raw, const float* occ,
                                float* rho, float* prs, float* pr2, int n,
                                const float* consts, int device,
                                void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  static_assert(kTailConsts == 5, "consts layout");
  const TailConsts t{consts[0], consts[1], consts[2], consts[3], consts[4]};
  const bool vec = aligned16(raw) && aligned16(occ) && aligned16(rho) &&
                   aligned16(prs) && aligned16(pr2);
  auto kernel = vec ? density_tail_kernel<true> : density_tail_kernel<false>;
  int grid = 0;
  const cudaError_t rc = grid_of(kernel, n, device, &grid);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      raw, occ, rho, prs, pr2, n, t);
  return static_cast<int>(cudaGetLastError());
}
