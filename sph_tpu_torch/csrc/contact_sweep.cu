// The colony contact sweep for Hopper (sm_90a): K4.
//
// Replaces: the Pallas kernel `_contact_kernel` (sph_tpu/ops/pallas/
// contact.py) as launched by `contact_sweep_pallas`.
//
// What it computes (the plain `_sweep_plain` of sph_tpu_torch/physics/
// contact_dense.py): on the [Z, Y, L] slot layout (L = X·K), every slot's
// own-side force[3] and torque[3], the sum of `contact_pair_terms` over the
// full stencil `contact_variants` — lane offset o ∈ [−P, P] with P = 2K − 1,
// then dz, then dy, without (0, 0, 0) — starting from +0. A partner past an
// edge of the array wraps in every axis, as the plain version's torch.roll
// does (in a pack the wrapped rows and planes are the sentinel margin).
//
// Design: the work unit is a BAND, `band_rows` whole rows of one plane
// (one contiguous run of the layout; the rows per band and the
// shared-memory bytes come from the host planner, ops/contact.py
// `band_plan`). One launch on the caller's stream, persistent
// (`contact_band_kernel`: as many blocks as fit, two per SM), whose blocks
// claim bands — all Z·bands of them — from a device cursor. Per band:
//  0. Gate. The band's occupancy, one contiguous run of rows·L floats, is
//     already in shared memory: when a block takes a band it claims the
//     band after it and starts a TMA bulk copy (cp.async.bulk on an
//     mbarrier of its own) of that band's occupancy into a second buffer,
//     so the copy lands while the current band is swept. Warp ballots over
//     the staged floats give the band's 32-bit occupancy masks, which stay
//     in shared memory. Every band gets +0 in its six output planes
//     (16-byte stores), and an empty band costs nothing more — the Pallas
//     kernel's `pl.when(occ_t…)`; the 1M colony is a ball inside a cube, so
//     a third of its bands are empty.
//  a. The band's occupied own slots listed in layout order from the masks
//     (a warp prefix sum of their popcounts), so every active lane of the
//     walk has a particle.
//  b. Walk, one thread per listed slot, two passes. The slot's STENCIL —
//     the nine row starts (z + dz, y + dy) and the 2P + 1 lanes l + o, each
//     wrapped as the plain roll wraps it — is formed once; a partner's
//     index is a row start plus a lane. Pass 1 visits the slot's 9·(2P +
//     1) − 1 variants (62 at K = 2), reads the partner's position and
//     radius from device memory through L1 (the band's partners are its
//     own rows and their neighbours, so neighbouring lanes share the lines
//     and L1 serves most of the reads), forms the overlap with the pair
//     term's own operations and marks, in a register bitmask, every
//     variant whose pair it cannot skip (overlap > ε, or NaN). Pass 2
//     walks the lane's own marks in variant order: it forms the same
//     overlap again, loads the partner's velocity and spin from global
//     memory and adds the full terms. The lanes of a warp thus run the full
//     terms max-over-lanes times, not at every variant where any lane has
//     a contact (K2's remedy, csrc/fluid_sweep.cu). A slot with no mark is
//     not written again: it already holds +0. (A one-pass walk, a halo of
//     the band's planes staged in shared memory, a ring that staged each
//     plane once a column of bands, and lanes that split a slot's screens
//     were all slower at the 1M colony: PERF.md.)
// The claims are pipelined: a block holds the band it sweeps, the next
// band (its occupancy in flight) and a claim on the one after, made at
// the top of the sweep and read at its end, so no claim's round trip and
// no occupancy load waits in line.
//
// The cursor. The caller keeps one zeroed pair of int32 counters per
// (device, stream) — [0] the next band to claim, [1] the blocks done — and
// the kernel leaves them zeroed: each block, after its last claim (the one
// past the bands, which ends its loop), fences and counts itself done, and
// the block that counts last (atomicAdd(done) == gridDim.x − 1) resets both.
// Every claim of every block precedes its count, so none follows the
// reset. That is safe across calls because calls on one stream run in
// order, each after the last block of the one before has reset the pair;
// and the wrapper drops the pair when a launch fails, so a call that did
// not run to its end never hands its counters on. (The design before had
// a second launch, one gate block per band, and a zeroed work buffer of
// the band list and masks, a memset, every call.)
//
// Why the skip keeps the bits: a skipped pair would have added an exact ±0
// to every component (force and torque carry the in_contact factor), and
// an accumulator that starts at +0 never holds −0, so the sum's bits are
// the plain version's. Precondition of "bitwise on every slot": finite
// fields. A NaN position or radius makes a NaN overlap, which is kept, so
// the slot's sum is NaN as in the plain version. What the skip does hide
// from non-finite input: a non-finite velocity or spin on a pair out of
// contact (the plain version carries it into the torque as NaN·0), and
// anything on an empty own slot (occ ≤ 0.5), which is written +0 (a pack's
// empty slot holds the fills, whose sums are +0; gather_back never reads
// them).
//
// Numerics: every operation is an explicitly rounded intrinsic in the
// plain version's order (no FMA contraction can form), rsqrtf where the
// plain version calls torch.rsqrt (the same CUDA function), IEEE square
// roots and an IEEE 1/x, so the kernel equals the plain version bitwise on
// the card.
//
// Floor modes (`sph_contact_floor`; the plain versions and the wrapper are
// ops/contact_floor.py). They replace the stub kernels of
// tools/probe_kernel_floor.py (`zero_kernel`, `pads_kernel`,
// `screen_kernel`), which that probe swaps into the Pallas kernel to split
// its time. Here each is the band sweep compiled to stop at a stage (the
// `Mode` template parameter; the production sweep is Mode::kFull), in the
// same persistent loop, plan and launch:
//  - kZero: +0 into every band's six planes, as `zero_kernel` writes zeros
//    into every block: no occupancy read, no gate, no staging, and no
//    shared memory but the claim slot (so more blocks fit on an SM).
//  - kPads: the gate and the reads of the band's stencil planes. Output 0
//    of every slot of an occupied band is f32(1e-37) times the sum of the
//    ten fields over planes z − 1, z, z + 1 at the slot's own (y, l),
//    fields outer, planes inner, from +0, each read through L1.
//  - kScreen: and the list of occupied own slots and pass 1, as a running
//    margin max(−1, overlap − ε over the variants) that keeps NaN, then the
//    band's max margin (NaN kept) by a block reduction; the margins wait
//    in shared memory, over the list. Only where it is > 0 does the band
//    store anything: output 0 holding the margins, and −1 on the band's
//    empty slots (the margin a pack's radius fill gives them; they are not
//    screened, as the production sweep screens only occupied slots). A
//    band that misses costs pass 1 and the reduction, and its output 0
//    stays +0.
// Each mode's output reads what its stage produced, so none is dead code.
//
// What bounds it on the H100: memory traffic. The least the function must
// move is the occupancy plane and the 6 output planes of Z·Y·L f32 (7 ×
// 54.9 MB at the 1M-cell colony), plus position and radius of occupied
// slots with an occupied partner and velocity and spin of slots in
// contact. A settled colony (rest length 2.96 > contact reach 2.0) has no
// pair in contact, but every occupied slot screens all 62 variants (65M
// screens of ~21 instructions, most against empty partners, and no FMA may
// form), so the walk is bound by instruction issue and latency, and the
// sweep by the walk, the +0 stores and the reads of the stencil's rows
// together (PERF.md; the design probes tools/probe_contact_sweep.py and
// tools/probe_contact_plans.py).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "persistent.cuh"

namespace {

constexpr int kFields = 10;  // px py pz vx vy vz ox oy oz rad
constexpr int kComps = 6;    // fx fy fz tx ty tz
constexpr int kThreads = 256;  // a block; two blocks per SM
constexpr int kWarps = kThreads / 32;
// The two mbarriers (one per occupancy buffer) and the slot of the next
// band's index, padded to 16 bytes.
constexpr int kTail = 32;

// How far the band sweep runs (the floor modes above); the values are
// `sph_contact_floor`'s mode codes.
enum class Mode : int { kZero = 0, kPads = 1, kScreen = 2, kFull = 3 };

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

struct Geom {
  int Z, Y, L;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the barrier's phase; a copy that never lands traps (a launch
// error the wrapper's caller sees) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (int spin = 0; !mbar_try_wait(bar, parity); ++spin)
    if (spin > (1 << 20)) __trap();
}

// TMA bulk copy global → shared (16-byte aligned ends, 16-byte multiple).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The variants of `contact_variants` in its order: f(j, dz, dy, o) for
// variant j. Every loop unrolls, so all arguments are compile-time
// constants at each call.
template <int K>
struct Variants {
  static constexpr int kP = 2 * K - 1;
  static constexpr int kCount = 9 * (2 * kP + 1) - 1;
  static constexpr int kWords = (kCount + 31) / 32;  // mark words
  static constexpr int kCentre = 9 * kP + 4;  // (0, 0, 0), left out

  template <class F>
  __device__ __forceinline__ static void each(F&& f) {
    int j = 0;
#pragma unroll
    for (int o = -kP; o <= kP; ++o)
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz)
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
          if (o == 0 && dz == 0 && dy == 0) continue;
          f(j++, dz, dy, o);
        }
  }
  // The (dz, dy, o) of variant j, at run time.
  __device__ __forceinline__ static void decode(int j, int& dz, int& dy,
                                                int& o) {
    const int v = j + (j >= kCentre ? 1 : 0);
    const int r = v % 9;
    o = v / 9 - kP;
    dz = r / 3 - 1;
    dy = r % 3 - 1;
  }
};

// An own slot's position and half radius, and its velocity and spin (read
// only when a pair is kept).
struct Own {
  float x, y, z, eff;
};
struct Motion {
  float vx, vy, vz, ox, oy, oz;
};

// The overlap of one pair, with contact_pair_terms' own operations.
struct Screen {
  float dx, dy, dz, rinv, dist, sum_r, overlap, eff_j;
};

__device__ __forceinline__ Screen screen(const Own& c, float qx, float qy,
                                         float qz, float qrad) {
  Screen s;
  s.eff_j = mul(qrad, 0.5f);
  s.dx = sub(c.x, qx);
  s.dy = sub(c.y, qy);
  s.dz = sub(c.z, qz);
  const float r2 =
      add(add(mul(s.dx, s.dx), mul(s.dy, s.dy)), mul(s.dz, s.dz));
  s.rinv = rsqrtf(at_least(r2, 1e-24f));
  s.dist = mul(r2, s.rinv);
  s.sum_r = add(c.eff, s.eff_j);
  s.overlap = sub(s.sum_r, s.dist);
  return s;
}

// The full terms of a kept pair (partner slot p), added to acc.
__device__ __forceinline__ void add_pair(float* acc, const Own& c,
                                         const Motion& v, const Screen& s,
                                         const InFields& in, size_t p,
                                         const Model& m) {
  const float qvx = in.f[3][p], qvy = in.f[4][p], qvz = in.f[5][p];
  const float qox = in.f[6][p], qoy = in.f[7][p], qoz = in.f[8][p];
  const float eff_i = c.eff, eff_j = s.eff_j;
  // 1 past the skip. For a NaN overlap the plain version has 0 here, but
  // `of` is NaN there too and makes all six terms NaN.
  const float in_contact = 1.0f;
  const float ux = mul(s.dx, s.rinv), uy = mul(s.dy, s.rinv),
              uz = mul(s.dz, s.rinv);
  const float inv_sum = __fdiv_rn(1.0f, at_least(s.sum_r, 1e-12f));
  const float of = clampf(mul(s.overlap, inv_sum), 0.0f, 1.0f);
  const float fo = clampf(sub(1.0f, mul(s.dist, inv_sum)), 0.0f, 1.0f);
  const float fmag = mul(mul(mul(fo, m.repulsion), of), in_contact);
  const float fx = mul(ux, fmag), fy = mul(uy, fmag), fz = mul(uz, fmag);

  const float sivx =
      add(v.vx, sub(mul(v.oy, mul(-uz, eff_i)), mul(v.oz, mul(-uy, eff_i))));
  const float sivy =
      add(v.vy, sub(mul(v.oz, mul(-ux, eff_i)), mul(v.ox, mul(-uz, eff_i))));
  const float sivz =
      add(v.vz, sub(mul(v.ox, mul(-uy, eff_i)), mul(v.oy, mul(-ux, eff_i))));
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

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// The global index of slot (z + dz, y + dy, l + o), wrapped.
__device__ __forceinline__ size_t partner(const Geom& g, int z, int y, int l,
                                          int dz, int dy, int o) {
  return (static_cast<size_t>(wrap(z + dz, g.Z)) * g.Y + wrap(y + dy, g.Y)) *
             g.L +
         wrap(l + o, g.L);
}

__device__ __forceinline__ Motion motion(const InFields& in, size_t i) {
  return Motion{in.f[3][i], in.f[4][i], in.f[5][i],
                in.f[6][i], in.f[7][i], in.f[8][i]};
}

// The position and radius fields the screen reads.
struct Pos {
  const float *x, *y, *z, *r;
};

__device__ __forceinline__ Pos pos_of(const InFields& in) {
  return Pos{in.f[0], in.f[1], in.f[2], in.f[9]};
}

// The screen of own slot c against the slot at index q, its position and
// radius read through the L1 cache.
__device__ __forceinline__ Screen screen_at(const Own& c, const Pos& p,
                                            int q) {
  return screen(c, __ldg(p.x + q), __ldg(p.y + q), __ldg(p.z + q),
                __ldg(p.r + q));
}

// Own slot (z, y, l)'s stencil: the global index of its partner (z + dz, y
// + dy, l + o) is row[3(dz + 1) + dy + 1] + lane[o + P], each axis wrapped
// as the plain roll wraps it — nine row starts and 2P + 1 lanes formed
// once a slot, added at every variant. Indexed only with compile-time
// constants (the unrolled variants), so both arrays stay in registers;
// 32-bit (the launch refuses a layout of 2^31 slots or more), so that the
// walk's pass 2 still fits in 128 registers without spilling.
template <int K>
struct Stencil {
  static constexpr int kP = 2 * K - 1;
  int row[9];
  int lane[2 * kP + 1];

  __device__ __forceinline__ Stencil(const Geom& g, int z, int y, int l) {
#pragma unroll
    for (int dz = -1; dz <= 1; ++dz)
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
        row[3 * (dz + 1) + dy + 1] =
            (wrap(z + dz, g.Z) * g.Y + wrap(y + dy, g.Y)) * g.L;
#pragma unroll
    for (int o = -kP; o <= kP; ++o) lane[o + kP] = wrap(l + o, g.L);
  }
  __device__ __forceinline__ int at(int dz, int dy, int o) const {
    return row[3 * (dz + 1) + dy + 1] + lane[o + kP];
  }
  __device__ __forceinline__ Own own(const Pos& p) const {
    const int i = at(0, 0, 0);
    return Own{__ldg(p.x + i), __ldg(p.y + i), __ldg(p.z + i),
               mul(__ldg(p.r + i), 0.5f)};
  }
};

// The walk of one occupied own slot (global slot i at z, y, l). Writes the
// slot's six sums where a pair is kept.
template <int K>
__device__ __forceinline__ void walk(const Geom& g, int z, int y, int l,
                                     size_t i, const InFields& in,
                                     const OutComps& out, const Model& m) {
  using V = Variants<K>;
  const Pos p = pos_of(in);
  const Stencil<K> st(g, z, y, l);
  const Own c = st.own(p);
  // Pass 1: mark every variant whose pair the screen keeps.
  unsigned marks[V::kWords];
#pragma unroll
  for (int w = 0; w < V::kWords; ++w) marks[w] = 0u;
  V::each([&](int j, int dz, int dy, int o) {
    const Screen s = screen_at(c, p, st.at(dz, dy, o));
    // Every term is an exact ±0 unless this fails; NaN fails it.
    if (!(s.overlap <= m.eps)) marks[j >> 5] |= 1u << (j & 31);
  });
  unsigned any = 0u;
#pragma unroll
  for (int w = 0; w < V::kWords; ++w) any |= marks[w];
  if (any == 0u) return;
  // Pass 2: this lane's marks in variant order, with the full terms.
  const Motion v = motion(in, i);
  float acc[kComps] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int w = 0; w < V::kWords; ++w) {
    unsigned b = marks[w];
    while (b != 0u) {
      const int j = w * 32 + __ffs(b) - 1;
      b &= b - 1u;
      int dz, dy, o;
      V::decode(j, dz, dy, o);
      const int q = static_cast<int>(partner(g, z, y, l, dz, dy, o));
      add_pair(acc, c, v, screen_at(c, p, q), in, q, m);
    }
  }
#pragma unroll
  for (int k = 0; k < kComps; ++k) out.c[k][i] = acc[k];
}

// max(a, b) that keeps NaN, as jnp.maximum and torch.maximum do.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  return (b != b || b > a) ? b : a;
}

// Pass 1 as the screen stub forms it: max(−1, overlap − ε over the
// variants in order), NaN kept.
template <int K>
__device__ __forceinline__ float margin(const Geom& g, int z, int y, int l,
                                        const InFields& in, const Model& m) {
  const Pos p = pos_of(in);
  const Stencil<K> st(g, z, y, l);
  const Own c = st.own(p);
  float mg = -1.0f;
  Variants<K>::each([&](int, int dz, int dy, int o) {
    mg = nan_max(mg, sub(screen_at(c, p, st.at(dz, dy, o)).overlap, m.eps));
  });
  return mg;
}

// The NaN-keeping max of v over the block, for every thread; `red` holds
// kWarps floats.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, d));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = nan_max(r, red[w]);
  return r;
}

// f(rank, own) for every occupied own slot of a band, `rank` its place in
// layout order, from the band's `words` occupancy masks (a warp prefix sum
// of their popcounts; one thread a word); `warp_count` holds kWarps ints.
// Returns the count. Every thread of the block calls it.
template <class F>
__device__ __forceinline__ int each_occupied(const unsigned* masks,
                                             int words, int* warp_count,
                                             F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int count = 0;
  for (int w0 = 0; w0 < words; w0 += kThreads) {
    const int w = w0 + threadIdx.x;
    unsigned mk = w < words ? masks[w] : 0u;
    const int mine = __popc(mk);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_count[warp] = incl;
    __syncthreads();
    int before = count + incl - mine, total = 0;
    for (int v = 0; v < kWarps; ++v) {
      before += v < warp ? warp_count[v] : 0;
      total += warp_count[v];
    }
    for (; mk != 0u; mk &= mk - 1u) f(before++, w * 32 + __ffs(mk) - 1);
    __syncthreads();
    count += total;
  }
  return count;
}

// The band block's shared memory: two occupancy buffers of band_rows·L
// floats, the tail (kTail: the two mbarriers and the next band's index),
// the list of occupied own slots, their masks (band_rows·L/32 words) and
// the warp counts. The zero mode has the tail alone. The host computes the
// same bytes (ops/contact.py `band_plan`).
__host__ __device__ inline size_t smem_bytes_of(int band_rows, int L) {
  const size_t own = static_cast<size_t>(band_rows) * L;
  return 4 * (3 * own + own / 32 + kWarps) + kTail;
}

// Thread 0: a TMA bulk copy of n floats from `src` into `dst`, completed on
// `bar` (n·4 a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void fetch_run(float* dst, const float* src, int n,
                                          uint64_t* bar) {
  mbar_expect_tx(bar, static_cast<uint32_t>(n) * 4u);
  bulk_load(dst, src, static_cast<uint32_t>(n) * 4u, bar);
}

// The one launch, persistent: each block claims bands from `cursor` (two
// zeroed int32 counters, left zeroed; the head of this file) until they run
// out. `M` stops the sweep at a stage (the floor modes); Mode::kFull is the
// production sweep.
template <int K, Mode M>
__global__ void __launch_bounds__(kThreads, 2)
    contact_band_kernel(InFields in, const float* __restrict__ occ,
                        OutComps out, Geom g, int band_rows, int bands,
                        Model m, int* cursor) {
  constexpr bool kGate = M != Mode::kZero;  // reads the occupancy
  extern __shared__ __align__(128) unsigned char smem[];
  const int own_max = band_rows * g.L;
  float* occ_buf = reinterpret_cast<float*>(smem);
  unsigned char* tail =
      reinterpret_cast<unsigned char*>(occ_buf + (kGate ? 2 * own_max : 0));
  uint64_t* bars = reinterpret_cast<uint64_t*>(tail);  // occ 0, occ 1
  int* next = reinterpret_cast<int*>(bars + 2);
  int* list = reinterpret_cast<int*>(tail + kTail);
  unsigned* masks = reinterpret_cast<unsigned*>(list + own_max);
  int* warp_count = reinterpret_cast<int*>(masks + own_max / 32);

  const int total = g.Z * bands;
  // A band's first slot, and its slots (the last band of a plane may be
  // shorter).
  const auto first_slot = [&](int band) {
    return (static_cast<size_t>(band / bands) * g.Y +
            band % bands * band_rows) *
           g.L;
  };
  const auto own_slots = [&](int band) {
    return min(band_rows, g.Y - band % bands * band_rows) * g.L;
  };
  // Thread 0 holds the claim on the band after the next.
  int claimed = 0;
  if (threadIdx.x == 0) {
    if constexpr (kGate) {
      for (int b = 0; b < 2; ++b) mbar_init(bars + b);
    }
    const int first = atomicAdd(cursor, 1);
    if constexpr (kGate) {
      if (first < total)
        fetch_run(occ_buf, occ + first_slot(first), own_slots(first), bars);
    }
    claimed = atomicAdd(cursor, 1);
    *next = first;
  }
  uint32_t occ_phase = 0;  // bit b: buffer b's parity
  for (int it = 0;; ++it) {
    // The last band's reads are done before its buffers are refilled, and
    // `next` (and, at first, the barriers' init) is visible.
    __syncthreads();
    const int band = *next;
    if (band >= total) break;
    const int cur = it & 1;
    // The claimed band's occupancy into the other buffer (its last band's,
    // read by now); then a claim on the band after it, read at the end.
    int following = 0;
    if (threadIdx.x == 0) {
      if constexpr (kGate) {
        if (claimed < total)
          fetch_run(occ_buf + (cur ^ 1) * own_max, occ + first_slot(claimed),
                    own_slots(claimed), bars + (cur ^ 1));
      }
      following = atomicAdd(cursor, 1);
    }
    const int z = band / bands, r0 = band % bands * band_rows;
    const int rows = min(band_rows, g.Y - r0);
    const int n_own = rows * g.L;
    const size_t base = first_slot(band);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

    // 0. The gate: the band's masks (one ballot per 32 staged floats; n_own
    // is a multiple of 32, so every warp's loop is uniform).
    bool live = false;
    if constexpr (kGate) {
      mbar_wait(bars + cur, occ_phase >> cur & 1u);
      occ_phase ^= 1u << cur;
      const float* o = occ_buf + cur * own_max;
      bool any = false;
      for (int t = threadIdx.x; t < n_own; t += kThreads) {
        const unsigned mk = __ballot_sync(0xffffffffu, o[t] > 0.5f);
        if ((threadIdx.x & 31) == 0) masks[t >> 5] = mk;
        any |= mk != 0u;
      }
      live = __syncthreads_or(any) != 0;
    }
    // a. +0 into the band's outputs (16-byte stores): all of an empty
    // band's work (every band's in the zero mode).
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      float4* dst = reinterpret_cast<float4*>(out.c[c] + base);
      for (int t = threadIdx.x; t < n_own / 4; t += kThreads) dst[t] = zero;
    }
    if (live) {
      // b. The list of the band's occupied own slots, in layout order,
      // from the masks (a warp prefix sum of their popcounts); its last
      // barrier also orders the +0 stores before the walk's.
      int count = 0;
      if constexpr (M == Mode::kScreen || M == Mode::kFull)
        count = each_occupied(masks, n_own / 32, warp_count,
                              [&](int rank, int own) { list[rank] = own; });

      if constexpr (M == Mode::kFull) {
        // c. Walk the occupied own slots.
        for (int t = threadIdx.x; t < count; t += kThreads) {
          const int own = list[t];
          const int ry = own / g.L, l = own - ry * g.L;
          walk<K>(g, z, r0 + ry, l, base + own, in, out, m);
        }
      } else if constexpr (M == Mode::kPads) {
        // Every slot of the band: f32(1e-37) · Σ fields (outer), dz
        // (inner). The barrier orders the +0 stores before these.
        __syncthreads();
        for (int t = threadIdx.x; t < n_own; t += kThreads) {
          const int ry = t / g.L, l = t - ry * g.L;
          float acc = 0.0f;
#pragma unroll
          for (int f = 0; f < kFields; ++f)
#pragma unroll
            for (int dz = -1; dz <= 1; ++dz)
              acc = add(acc,
                        __ldg(in.f[f] + partner(g, z, r0 + ry, l, dz, 0, 0)));
          out.c[0][base + t] = mul(acc, 1e-37f);
        }
      } else if constexpr (M == Mode::kScreen) {
        // Pass 1 of every occupied own slot, its margin over its list
        // entry (the thread that reads an entry writes it) and into a
        // running max; then the band's max margin. Where it is > 0 (a
        // band the production sweep would walk), the margins go to their
        // slots in list order and −1 into the empty slots; else output 0
        // keeps its +0 and nothing is stored.
        float band_max = -1.0f;
        for (int t = threadIdx.x; t < count; t += kThreads) {
          const int own = list[t];
          const int ry = own / g.L, l = own - ry * g.L;
          const float mg = margin<K>(g, z, r0 + ry, l, in, m);
          list[t] = __float_as_int(mg);
          band_max = nan_max(band_max, mg);
        }
        // warp_count is free once the list is built; the branch is the
        // block's, and its barrier keeps the reduction's reads of `red`
        // before each_occupied's writes.
        float* red = reinterpret_cast<float*>(warp_count);
        if (block_max(band_max, red) > 0.0f) {
          __syncthreads();
          each_occupied(masks, n_own / 32, warp_count,
                        [&](int rank, int own) {
                          out.c[0][base + own] = __int_as_float(list[rank]);
                        });
          for (int t = threadIdx.x; t < n_own; t += kThreads)
            if (!(masks[t >> 5] >> (t & 31) & 1u))
              out.c[0][base + t] = -1.0f;
        }
      }
    }
    if (threadIdx.x == 0) {
      *next = claimed;
      claimed = following;
    }
  }
  // This block's claims are all made (the last one, past the bands, ended
  // its loop); the block that counts itself done last leaves the cursor
  // zeroed for the next call on the stream.
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(cursor + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      atomicExch(cursor, 0);
      atomicExch(cursor + 1, 0);
    }
  }
}

// The persistent grid of <K, M> at `smem_bytes` (checked against the
// kernel's own layout) on `device`: the blocks resident at once on every
// SM (csrc/persistent.cuh), and the launch's shared memory. Returns a
// cudaError_t value.
template <int K, Mode M>
int grid_k(const Geom& g, int band_rows, int smem_bytes, int device,
           int* grid, int* smem) {
  if (static_cast<size_t>(smem_bytes) != smem_bytes_of(band_rows, g.L))
    return cudaErrorInvalidValue;
  *smem = M == Mode::kZero ? kTail : smem_bytes;
  // The staged modes read their partners through L1: they ask for the
  // shared memory two blocks take (1 KB a block reserved, of the SM's
  // 233,472 bytes) and leave the rest of the SM's 256 KB to L1.
  const int carveout =
      M == Mode::kZero
          ? -1
          : std::min(100, (2 * (*smem + 1024) * 100 + 233471) / 233472);
  return sph::persistent_grid(
      reinterpret_cast<const void*>(contact_band_kernel<K, M>), kThreads,
      *smem, device, grid, carveout);
}

// Launches the sweep on `stream` (its persistent grid cached per (kernel,
// shared memory, device): csrc/persistent.cuh); returns a cudaError_t
// value (0 on success).
template <int K, Mode M>
int launch_k(const InFields& in, const float* occ, const OutComps& out,
             const Geom& g, int band_rows, int smem_bytes, const Model& m,
             int* cursor, int device, cudaStream_t stream) {
  int grid = 0, smem = 0;
  const int rc = grid_k<K, M>(g, band_rows, smem_bytes, device, &grid, &smem);
  if (rc != cudaSuccess) return rc;
  const int bands = (g.Y + band_rows - 1) / band_rows;
  contact_band_kernel<K, M>
      <<<std::min(grid, g.Z * bands), kThreads, smem, stream>>>(
          in, occ, out, g, band_rows, bands, m, cursor);
  return static_cast<int>(cudaGetLastError());
}

// The layouts the kernels take: whole 32-slot masks, fewer than 2^31
// slots (32-bit stencil indices).
bool valid(const Geom& g, int band_rows) {
  return g.Z >= 1 && g.Y >= 1 && g.L >= 32 && g.L % 32 == 0 &&
         band_rows >= 1 &&
         static_cast<long long>(g.Z) * g.Y * g.L <= 0x7fffffffLL;
}

// The K the kernels are built for; anything else is refused.
template <Mode M>
int launch_mode(const InFields& in, const float* occ, const OutComps& out,
                const Geom& g, int K, int band_rows, int smem_bytes,
                const Model& m, int* cursor, int device,
                cudaStream_t stream) {
  if (!valid(g, band_rows)) return cudaErrorInvalidValue;
  switch (K) {
    case 1:
      return launch_k<1, M>(in, occ, out, g, band_rows, smem_bytes, m, cursor,
                            device, stream);
    case 2:
      return launch_k<2, M>(in, occ, out, g, band_rows, smem_bytes, m, cursor,
                            device, stream);
    case 4:
      return launch_k<4, M>(in, occ, out, g, band_rows, smem_bytes, m, cursor,
                            device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <Mode M>
int grid_mode(const Geom& g, int K, int band_rows, int smem_bytes,
              int device, int* grid) {
  if (!valid(g, band_rows)) return cudaErrorInvalidValue;
  int smem = 0;
  switch (K) {
    case 1:
      return grid_k<1, M>(g, band_rows, smem_bytes, device, grid, &smem);
    case 2:
      return grid_k<2, M>(g, band_rows, smem_bytes, device, grid, &smem);
    case 4:
      return grid_k<4, M>(g, band_rows, smem_bytes, device, grid, &smem);
    default:
      return cudaErrorInvalidValue;
  }
}

InFields in_fields(const void* const* fields) {
  InFields in;
  for (int i = 0; i < kFields; ++i)
    in.f[i] = static_cast<const float*>(fields[i]);
  return in;
}

OutComps out_comps(void* const* outs) {
  OutComps out;
  for (int i = 0; i < kComps; ++i) out.c[i] = static_cast<float*>(outs[i]);
  return out;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns a cudaError_t value (0 on success); nothing is synchronised.
// `band_rows` and `smem_bytes` come from ops/contact.py `band_plan`; a
// mismatch with the kernel's own layout returns cudaErrorInvalidValue.
// `cursor` is the stream's pair of zeroed int32 counters (the head of this
// file), which the launch leaves zeroed; `device` is the current device.
// Built for K ∈ {1, 2, 4} (the repository's colony scenes); anything else
// is refused.
extern "C" int sph_contact_sweep(const void* const* fields, const float* occ,
                                 void* const* outs, int* cursor, int Z, int Y,
                                 int L, int K, int band_rows, int smem_bytes,
                                 float eps, float slip_eps,
                                 float repulsion, float torque_factor,
                                 float mult, int device, void* stream) {
  return launch_mode<Mode::kFull>(
      in_fields(fields), occ, out_comps(outs), Geom{Z, Y, L}, K, band_rows,
      smem_bytes, Model{eps, slip_eps, repulsion, torque_factor, mult},
      cursor, device, static_cast<cudaStream_t>(stream));
}

// The floor modes (mode 0 zero, 1 pads, 2 screen; see the head of this
// file), with the arguments of `sph_contact_sweep`; the screen reads only
// `eps` of the model.
extern "C" int sph_contact_floor(const void* const* fields, const float* occ,
                                 void* const* outs, int* cursor, int Z, int Y,
                                 int L, int K, int band_rows, int smem_bytes,
                                 int mode, float eps, int device,
                                 void* stream) {
  const InFields in = in_fields(fields);
  const OutComps out = out_comps(outs);
  const Geom g{Z, Y, L};
  const Model m{eps, 0.0f, 0.0f, 0.0f, 0.0f};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case static_cast<int>(Mode::kZero):
      return launch_mode<Mode::kZero>(in, occ, out, g, K, band_rows,
                                      smem_bytes, m, cursor, device, st);
    case static_cast<int>(Mode::kPads):
      return launch_mode<Mode::kPads>(in, occ, out, g, K, band_rows,
                                      smem_bytes, m, cursor, device, st);
    case static_cast<int>(Mode::kScreen):
      return launch_mode<Mode::kScreen>(in, occ, out, g, K, band_rows,
                                        smem_bytes, m, cursor, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The persistent grid of a mode (0 zero … 3 full) at a band plan, as a
// launch with the same arguments sizes it: the blocks resident at once on
// every SM (the occupancy API), into *grid; returns a cudaError_t value.
extern "C" int sph_contact_grid(int Z, int Y, int L, int K, int band_rows,
                                int smem_bytes, int mode, int device,
                                int* grid) {
  const Geom g{Z, Y, L};
  switch (mode) {
    case static_cast<int>(Mode::kZero):
      return grid_mode<Mode::kZero>(g, K, band_rows, smem_bytes, device, grid);
    case static_cast<int>(Mode::kPads):
      return grid_mode<Mode::kPads>(g, K, band_rows, smem_bytes, device, grid);
    case static_cast<int>(Mode::kScreen):
      return grid_mode<Mode::kScreen>(g, K, band_rows, smem_bytes, device,
                                      grid);
    case static_cast<int>(Mode::kFull):
      return grid_mode<Mode::kFull>(g, K, band_rows, smem_bytes, device, grid);
    default:
      return cudaErrorInvalidValue;
  }
}
