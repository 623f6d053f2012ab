// The colony contact sweep for Hopper (sm_90a): K4.
//
// Replaces: the Pallas kernel `_contact_kernel` (sph_tpu/ops/pallas/
// contact.py) as launched by `contact_sweep_pallas`.
//
// What it computes (the plain `_sweep_plain` of sph_tpu_torch/physics/
// contact_dense.py): on the [Z, Y, L] slot layout (L = X·K), every slot's
// own-side force[3] and torque[3], the sum of `contact_pair_terms` over the
// full stencil `contact_variants` — lane offset o ∈ [−(2K−1), 2K−1], then
// dz, then dy, without (0, 0, 0) — starting from +0. Partners past an edge
// wrap, as the plain version's rolls do; they only ever meet sentinel lanes.
//
// Design: ONE THREAD PER SLOT, l fastest, so neighbouring threads read
// neighbouring partners. A thread whose own slot is empty (occ = 0, radius
// fill −1e3) can touch nothing and writes +0 at once. For each variant a
// thread first loads the partner's position and radius and forms the
// overlap exactly as the pair terms do; it skips the pair only when
// overlap ≤ contact_epsilon, and otherwise (a NaN overlap included) loads
// the other six fields and adds the full terms. A skipped pair would have
// added an exact ±0 to every component (force and torque carry the
// in_contact factor), and an accumulator that starts at +0 never holds −0,
// so the skip leaves the sum's bits as the plain version's. Precondition
// of "bitwise on every slot": finite fields. A NaN position or radius
// makes a NaN overlap, which takes the full terms, so the slot's sum is
// NaN as in the plain version. What the skip does hide from non-finite
// input: a non-finite velocity or spin on a pair out of contact (the
// plain version carries it into the torque as NaN·0), and anything on an
// empty own slot, which is written +0 (gather_back never reads those).
// The TPU kernel's halo pads, row blocks and tile-level screen have no
// counterpart.
//
// Numerics: every operation is an explicitly rounded intrinsic in the
// plain version's order (no FMA contraction can form), rsqrtf where the
// plain version calls torch.rsqrt (the same CUDA function), IEEE square
// roots and an IEEE 1/x, so the kernel equals the plain version bitwise on
// the card.
//
// What bounds it on the H100: memory traffic. The least the function must
// move is the occupancy plane and the 6 output planes of Z·Y·L f32 (7 ×
// 54.9 MB at the 1M-cell colony), plus position and radius of occupied
// slots that have an occupied partner and the six velocity/spin fields of
// slots in contact. A settled colony (rest length 2.96 > contact reach
// 2.0) has almost no pair in contact, so an occupied thread does 62
// overlap tests of ~16 operations each; ~92% of the threads are empty and
// only read their occupancy and write six zeros.

#include <cuda_runtime.h>

namespace {

constexpr int kFields = 10;  // px py pz vx vy vz ox oy oz rad
constexpr int kComps = 6;    // fx fy fz tx ty tz
constexpr int kThreads = 256;

struct InFields {
  const float* f[kFields];
};

struct OutComps {
  float* c[kComps];
};

struct Model {
  float eps;             // contact_epsilon
  float slip_eps;        // slip_epsilon
  float repulsion;       // repulsion_strength
  float torque_factor;
  float mult;            // rolling_contact_radius_multiplier
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// torch.clamp semantics (NaN passes through).
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float at_least(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float at_most(float x, float hi) {
  return x > hi ? hi : x;
}

__global__ void contact_sweep_kernel(InFields in, const float* __restrict__ occ,
                                     OutComps out, int Z, int Y, int L, int K,
                                     Model m) {
  const long long total = static_cast<long long>(Z) * Y * L;
  const long long s = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (s >= total) return;
  float acc[kComps] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (occ[s] > 0.5f) {
    const int l = static_cast<int>(s % L);
    const int y = static_cast<int>((s / L) % Y);
    const int z = static_cast<int>(s / (static_cast<long long>(L) * Y));
    const float cx = in.f[0][s], cy = in.f[1][s], cz = in.f[2][s];
    const float cvx = in.f[3][s], cvy = in.f[4][s], cvz = in.f[5][s];
    const float cox = in.f[6][s], coy = in.f[7][s], coz = in.f[8][s];
    const float crad = in.f[9][s];
    const float eff_i = mul(crad, 0.5f);
    const int span = 2 * K - 1;
    for (int o = -span; o <= span; ++o) {
      int ll = l + o;
      if (ll < 0) ll += L;
      if (ll >= L) ll -= L;
      for (int dz = -1; dz <= 1; ++dz) {
        int zz = z + dz;
        if (zz < 0) zz += Z;
        if (zz >= Z) zz -= Z;
        for (int dyy = -1; dyy <= 1; ++dyy) {
          if (o == 0 && dz == 0 && dyy == 0) continue;
          int yy = y + dyy;
          if (yy < 0) yy += Y;
          if (yy >= Y) yy -= Y;
          const long long p = (static_cast<long long>(zz) * Y + yy) * L + ll;
          const float qx = in.f[0][p], qy = in.f[1][p], qz = in.f[2][p];
          const float qrad = in.f[9][p];
          const float eff_j = mul(qrad, 0.5f);
          const float dx = sub(cx, qx);
          const float dy = sub(cy, qy);
          const float dzf = sub(cz, qz);
          const float r2 = add(add(mul(dx, dx), mul(dy, dy)), mul(dzf, dzf));
          const float rinv = rsqrtf(at_least(r2, 1e-24f));
          const float dist = mul(r2, rinv);
          const float sum_r = add(eff_i, eff_j);
          const float overlap = sub(sum_r, dist);
          // Every term is an exact ±0; a NaN overlap goes on, as in the
          // plain version, so a blown-up pair stays NaN.
          if (overlap <= m.eps) continue;

          const float qvx = in.f[3][p], qvy = in.f[4][p], qvz = in.f[5][p];
          const float qox = in.f[6][p], qoy = in.f[7][p], qoz = in.f[8][p];
          // 1 past the skip. For a NaN overlap the plain version has 0
          // here, but `of` is NaN there too and makes all six terms NaN.
          const float in_contact = 1.0f;
          const float ux = mul(dx, rinv), uy = mul(dy, rinv),
                      uz = mul(dzf, rinv);
          const float inv_sum = __fdiv_rn(1.0f, at_least(sum_r, 1e-12f));
          const float of = clampf(mul(overlap, inv_sum), 0.0f, 1.0f);
          const float fo = clampf(sub(1.0f, mul(dist, inv_sum)), 0.0f, 1.0f);
          const float fmag = mul(mul(mul(fo, m.repulsion), of), in_contact);
          const float fx = mul(ux, fmag), fy = mul(uy, fmag),
                      fz = mul(uz, fmag);

          const float sivx =
              add(cvx, sub(mul(coy, mul(-uz, eff_i)), mul(coz, mul(-uy, eff_i))));
          const float sivy =
              add(cvy, sub(mul(coz, mul(-ux, eff_i)), mul(cox, mul(-uz, eff_i))));
          const float sivz =
              add(cvz, sub(mul(cox, mul(-uy, eff_i)), mul(coy, mul(-ux, eff_i))));
          const float sjvx =
              add(qvx, sub(mul(qoy, mul(uz, eff_j)), mul(qoz, mul(uy, eff_j))));
          const float sjvy =
              add(qvy, sub(mul(qoz, mul(ux, eff_j)), mul(qox, mul(uz, eff_j))));
          const float sjvz =
              add(qvz, sub(mul(qox, mul(uy, eff_j)), mul(qoy, mul(ux, eff_j))));
          const float rvx = sub(sivx, sjvx), rvy = sub(sivy, sjvy),
                      rvz = sub(sivz, sjvz);
          const float rn = add(add(mul(rvx, ux), mul(rvy, uy)), mul(rvz, uz));
          const float tx = sub(rvx, mul(ux, rn)), ty = sub(rvy, mul(uy, rn)),
                      tz = sub(rvz, mul(uz, rn));
          const float slip2 = add(add(mul(tx, tx), mul(ty, ty)), mul(tz, tz));
          const float slip_inv = rsqrtf(at_least(slip2, 1e-30f));
          const float slip = mul(slip2, slip_inv);
          const float slipping = mul(in_contact, slip > m.slip_eps ? 1.0f : 0.0f);
          const float torque_input = fabsf(mul(slip, m.torque_factor));
          const float friction_mag = at_most(
              mul(torque_input, __fsqrt_rn(__fsqrt_rn(torque_input))), 10.0f);
          const float scale = mul(
              mul(mul(mul(mul(mul(of, of), m.mult), friction_mag), slip_inv),
                  slipping),
              eff_i);
          const float bx = mul(sub(mul(uy, tz), mul(uz, ty)), scale);
          const float by = mul(sub(mul(uz, tx), mul(ux, tz)), scale);
          const float bz = mul(sub(mul(ux, ty), mul(uy, tx)), scale);
          acc[0] = add(acc[0], fx);
          acc[1] = add(acc[1], fy);
          acc[2] = add(acc[2], fz);
          acc[3] = add(acc[3], bx);
          acc[4] = add(acc[4], by);
          acc[5] = add(acc[5], bz);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kComps; ++c) out.c[c][s] = acc[c];
}

}  // namespace

extern "C" int sph_contact_sweep(const void* const* fields, const float* occ,
                                 void* const* outs, int Z, int Y, int L,
                                 int K, float eps, float slip_eps,
                                 float repulsion, float torque_factor,
                                 float mult, void* stream) {
  InFields in;
  for (int i = 0; i < kFields; ++i) {
    in.f[i] = static_cast<const float*>(fields[i]);
  }
  OutComps out;
  for (int i = 0; i < kComps; ++i) out.c[i] = static_cast<float*>(outs[i]);
  const Model m{eps, slip_eps, repulsion, torque_factor, mult};
  const long long total = static_cast<long long>(Z) * Y * L;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0) {
    contact_sweep_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        in, occ, out, Z, Y, L, K, m);
  }
  return static_cast<int>(cudaGetLastError());
}
