// Dense-grid pair sweeps for Hopper (sm_90a): K1 density and K2 pressure +
// viscosity acceleration.
//
// Replaces: the Pallas kernel `_newton_kernel` (sph_tpu/ops/pallas/fluid.py)
// as launched by `density_pallas` (K1) and `accel_pallas` (K2).
//
// Layout: every field is [n0, K, C] f32 (plane, slot, fused row·cell), C
// fastest; empty slots hold sentinel positions (1e9) that every pair test
// rejects arithmetically, and one margin cell rings the domain, so a fused
// offset dy·X + dx that crosses a row boundary lands on a sentinel margin.
//
// Design (simple first): ONE THREAD PER SLOT (z, k, c), c fastest, so the
// partner reads of neighbouring threads — one slot of cell c + dy·X + dx in
// plane z + dz — are neighbouring addresses and coalesce. Each thread runs
// the OWN-ONLY full stencil (27 cells × K slots in 3D, 9 × K in 2D) and
// writes its own sum: no mirror part arrays, no combine pass, no atomics.
// A thread on an empty own slot writes 0 and returns (the caller's
// rest-density fixup, and the integrator's occupancy mask, cover those
// lanes).
//
// Summation order: the thread visits its 27·K partners in the order in
// which the Newton-halved plain version (`_sweep_plain` +
// `combine_mirror_parts`, sph_tpu_torch/sph/dense.py, the JAX twin's order)
// accumulates them for this slot: the forward terms of groups A, B, C, D,
// with the A and B mirror lumps folded in after their group, then the
// row part and the three plane parts. A mirror term the plain version
// computes on the partner's lane is the exact negation (accel) or the
// exact value (density) of the term computed here, so every partial sum is
// the same float. Every operation is an explicitly rounded intrinsic
// (__fadd_rn, __fmul_rn, ...), so nvcc forms no FMA, and the direction
// uses rsqrtf, as torch.rsqrt does on the card: K1 and K2 then match their
// plain versions bit for bit on occupied slots, and the tolerance check
// (rtol 1e-5, atol 1e-6·max|x|) has its whole margin. (A reordered or
// FMA-contracted sum does not: the pressure terms cancel to ~1% of their
// size, and the JAX twin's eager and jitted builds — same order, different
// FMA contraction — already differ by 1.6e-6·max|x| at a 3,000-particle
// dam break on the CPU.) Partners outside the array are skipped;
// only margin lanes reach there, where the plain version adds ±0.
//
// What bounds it on the H100: at the dam-break layout ~89% of the slots are
// empty, so most threads exit after one load; each occupied one makes
// 27·K partner loads of 3 (K1) or 8 (K2) fields, served by L1/L2 (a partner
// plane is reused by 27 neighbouring cells) rather than a shared-memory
// plane tile, and the empty threads of a warp waste its instruction slots. Left
// for later: a block-per-(plane, column-tile) variant staging the three
// planes in shared memory, compacting occupied slots per warp, and
// Newton-halving the pair work.

#include <cuda_runtime.h>

namespace {

struct Geom {
  int n0;  // planes
  int k;   // slots per cell (even)
  int c;   // fused row·cell length
  int x;   // row length (fused stride of one row)
  int s0;  // stencil along planes
  int s1;  // stencil along rows
};

// Walks the partners of own slot (z, k, c) in the plain version's order and
// returns the folded sum in out[0..NC). term(j, t) writes the NC pair terms
// of the own slot against partner index j.
template <int NC, class Term>
__device__ void twin_order_sweep(const Geom& g, int z, int k, int c,
                                 float self_init, const Term& term,
                                 float* out) {
  float acc[NC];
  for (int i = 0; i < NC; ++i) acc[i] = 0.0f;
  acc[0] = self_init;

  auto add = [&](float* a, int zq, int slot, int cq) {
    if (zq < 0 || zq >= g.n0 || cq < 0 || cq >= g.c) return;
    float t[NC];
    term((zq * g.k + slot) * g.c + cq, t);
    for (int i = 0; i < NC; ++i) a[i] = __fadd_rn(a[i], t[i]);
  };
  auto fold = [&](float* a, const float* b) {
    for (int i = 0; i < NC; ++i) a[i] = __fadd_rn(a[i], b[i]);
  };
  auto fwd = [&](int m) { return (k + m) % g.k; };        // partner slot
  auto mir = [&](int m) { return (k - m + g.k) % g.k; };  // mirror source
  const int half = g.k / 2;
  float lump[NC], part[NC];

  // Group A: same cell, m in [1, K/2]; its mirrors m in [1, K/2).
  for (int m = 1; m <= half; ++m) add(acc, z, fwd(m), c);
  for (int i = 0; i < NC; ++i) lump[i] = 0.0f;
  for (int m = 1; m < half; ++m) add(lump, z, mir(m), c);
  fold(acc, lump);
  // Group B: next cell in the row; its mirrors cover the previous cell.
  for (int m = 0; m < g.k; ++m) add(acc, z, fwd(m), c + 1);
  for (int i = 0; i < NC; ++i) lump[i] = 0.0f;
  for (int m = 0; m < g.k; ++m) add(lump, z, mir(m), c - 1);
  fold(acc, lump);
  // Group C forward: next row.
  if (g.s1) {
    for (int dx = -1; dx <= 1; ++dx)
      for (int m = 0; m < g.k; ++m) add(acc, z, fwd(m), c + g.x + dx);
  }
  // Group D forward: next plane, rows dy in dys.
  if (g.s0) {
    for (int dy = -g.s1; dy <= g.s1; ++dy)
      for (int dx = -1; dx <= 1; ++dx)
        for (int m = 0; m < g.k; ++m)
          add(acc, z + 1, fwd(m), c + dy * g.x + dx);
  }
  // Mirror parts, folded as combine_mirror_parts does: the row part, then
  // one part per dy of the previous plane; each part sums one lump per dx.
  if (g.s1) {
    for (int i = 0; i < NC; ++i) part[i] = 0.0f;
    for (int dx = -1; dx <= 1; ++dx) {
      for (int i = 0; i < NC; ++i) lump[i] = 0.0f;
      for (int m = 0; m < g.k; ++m) add(lump, z, mir(m), c - g.x - dx);
      fold(part, lump);
    }
    fold(acc, part);
  }
  if (g.s0) {
    for (int dy = -g.s1; dy <= g.s1; ++dy) {
      for (int i = 0; i < NC; ++i) part[i] = 0.0f;
      for (int dx = -1; dx <= 1; ++dx) {
        for (int i = 0; i < NC; ++i) lump[i] = 0.0f;
        for (int m = 0; m < g.k; ++m)
          add(lump, z - 1, mir(m), c - dy * g.x - dx);
        fold(part, lump);
      }
      fold(acc, part);
    }
  }
  for (int i = 0; i < NC; ++i) out[i] = acc[i];
}

__global__ void density_sweep_kernel(const float* __restrict__ px,
                                     const float* __restrict__ py,
                                     const float* __restrict__ pz,
                                     const float* __restrict__ occ,
                                     float* __restrict__ out, Geom g,
                                     float h2, float self_init,
                                     float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.n0 * g.k * g.c) return;
  if (!(occ[i] > 0.5f)) {
    out[i] = 0.0f;
    return;
  }
  const int c = i % g.c;
  const int k = (i / g.c) % g.k;
  const int z = i / (g.k * g.c);
  const float cx = px[i], cy = py[i], cz = pz[i];
  // density_pair_term: t = max(h² − r², 0); t·t·t.
  auto term = [&](int j, float* t) {
    const float ddx = __fsub_rn(cx, px[j]);
    const float ddy = __fsub_rn(cy, py[j]);
    const float ddz = __fsub_rn(cz, pz[j]);
    const float r2 = __fadd_rn(
        __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)),
        __fmul_rn(ddz, ddz));
    const float u = fmaxf(__fsub_rn(h2, r2), 0.0f);
    t[0] = __fmul_rn(__fmul_rn(u, u), u);
  };
  float acc;
  twin_order_sweep<1>(g, z, k, c, self_init, term, &acc);
  out[i] = __fmul_rn(scale, acc);
}

__global__ void accel_sweep_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ vx,
    const float* __restrict__ vy, const float* __restrict__ vz,
    const float* __restrict__ irho, const float* __restrict__ pr2,
    const float* __restrict__ occ, float* __restrict__ ax,
    float* __restrict__ ay, float* __restrict__ az, Geom g, float h,
    float neg_m_spiky, float visc_mc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.n0 * g.k * g.c) return;
  if (!(occ[i] > 0.5f)) {
    ax[i] = 0.0f;
    ay[i] = 0.0f;
    az[i] = 0.0f;
    return;
  }
  const int c = i % g.c;
  const int k = (i / g.c) % g.k;
  const int z = i / (g.k * g.c);
  const float cx = px[i], cy = py[i], cz = pz[i];
  const float cvx = vx[i], cvy = vy[i], cvz = vz[i];
  const float cirho = irho[i], cpr2 = pr2[i];
  const float r2_floor = static_cast<float>(1e-18);
  const float self_r2 = static_cast<float>(1e-16);
  // accel_pair_terms, operation for operation.
  auto term = [&](int j, float* t) {
    const float ddx = __fsub_rn(cx, px[j]);
    const float ddy = __fsub_rn(cy, py[j]);
    const float ddz = __fsub_rn(cz, pz[j]);
    const float r2 = __fadd_rn(
        __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)),
        __fmul_rn(ddz, ddz));
    const float rinv = rsqrtf(fmaxf(r2, r2_floor));
    const float r = __fmul_rn(r2, rinv);
    const float not_self = r2 > self_r2 ? 1.0f : 0.0f;
    const float hr = fmaxf(__fsub_rn(h, r), 0.0f);
    const float hrm = __fmul_rn(hr, not_self);
    const float cp = __fmul_rn(
        __fmul_rn(__fmul_rn(__fmul_rn(neg_m_spiky, hrm), hr), rinv),
        __fadd_rn(cpr2, pr2[j]));
    const float cv =
        __fmul_rn(__fmul_rn(visc_mc, hrm), __fmul_rn(cirho, irho[j]));
    t[0] = __fadd_rn(__fmul_rn(cp, ddx),
                     __fmul_rn(cv, __fsub_rn(vx[j], cvx)));
    t[1] = __fadd_rn(__fmul_rn(cp, ddy),
                     __fmul_rn(cv, __fsub_rn(vy[j], cvy)));
    t[2] = __fadd_rn(__fmul_rn(cp, ddz),
                     __fmul_rn(cv, __fsub_rn(vz[j], cvz)));
  };
  float acc[3];
  twin_order_sweep<3>(g, z, k, c, 0.0f, term, acc);
  ax[i] = acc[0];
  ay[i] = acc[1];
  az[i] = acc[2];
}

constexpr int kThreads = 256;

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns cudaGetLastError() (0 on success); nothing is synchronised.

extern "C" int sph_density_sweep(const float* px, const float* py,
                                 const float* pz, const float* occ,
                                 float* out, int n0, int k, int c, int x,
                                 int stencil0, int stencil1, float h2,
                                 float self_init, float scale,
                                 void* stream) {
  const Geom g{n0, k, c, x, stencil0 ? 1 : 0, stencil1 ? 1 : 0};
  density_sweep_kernel<<<blocks_for(n0 * k * c), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, occ, out, g, h2, self_init, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sph_accel_sweep(const float* px, const float* py,
                               const float* pz, const float* vx,
                               const float* vy, const float* vz,
                               const float* irho, const float* pr2,
                               const float* occ, float* ax, float* ay,
                               float* az, int n0, int k, int c, int x,
                               int stencil0, int stencil1, float h,
                               float neg_m_spiky, float visc_mc,
                               void* stream) {
  const Geom g{n0, k, c, x, stencil0 ? 1 : 0, stencil1 ? 1 : 0};
  accel_sweep_kernel<<<blocks_for(n0 * k * c), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, vx, vy, vz, irho, pr2, occ, ax, ay, az, g, h, neg_m_spiky,
      visc_mc);
  return static_cast<int>(cudaGetLastError());
}
