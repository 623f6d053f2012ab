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
// `band_plan`). Two launches on the caller's stream:
//  1. Gate (`contact_gate_kernel`, one block per band). The block reads the
//     band's occupancy (coalesced loads, kLoads in flight) into 32-bit
//     masks with warp ballots. An empty band gets +0 in its six output
//     planes (16-byte stores) and costs nothing more — the Pallas kernel's
//     `pl.when(occ_t…)`; the 1M colony is a ball inside a cube, so a third
//     of its bands are empty. A band with an occupied slot keeps its masks
//     in the work buffer and is appended to the work list.
//  2. Sweep (`contact_band_kernel`, persistent: as many blocks as fit, two
//     per SM, each taking listed bands from an atomic counter). Per band:
//     a. Halo staging. TMA bulk copies (cp.async.bulk, completed on an
//        mbarrier), one per thread, of px, py, pz and rad for planes
//        z − 1, z, z + 1 and the band's rows ± 1, each row and plane index
//        wrapped as the plain roll wraps it. A staged row is the row's L
//        lanes with kPad ≥ P lanes on each side.
//     b. While the copies land: +0 into the band's six output planes
//        (16-byte stores; the walk then overwrites only the slots that
//        touch, in the same block, so L2 merges the two writes), and the
//        band's occupied own slots listed in layout order from the gate's
//        masks (a warp prefix sum of their popcounts), so every active lane
//        of the walk has a particle. Then the pads: each takes the same
//        row's wrapped lanes from the landed row (the last kPad lanes to
//        the left, the first kPad to the right), as the Pallas kernel's
//        `concat([yp[:, -P:], yp, yp[:, :P]])` does. So no partner needs a
//        bounds test or an index wrap.
//     c. Walk, one thread per listed slot, two passes. Pass 1 visits the
//        slot's 9·(2P + 1) − 1 variants (62 at K = 2) with compile-time
//        lane, row and plane offsets into the halo, forms the overlap with
//        the pair term's own operations and marks, in a register bitmask,
//        every variant whose pair it cannot skip (overlap > ε, or NaN).
//        Pass 2 walks the lane's own marks in variant order: it forms the
//        same overlap again, loads the partner's velocity and spin from
//        global memory and adds the full terms. The lanes of a warp thus
//        run the full terms max-over-lanes times, not at every variant
//        where any lane has a contact (K2's remedy, csrc/fluid_sweep.cu). A
//        slot with no mark is not written again: it already holds +0. (A
//        one-pass walk, the full terms inline at each kept variant, was
//        1.7–2.3× slower at the 1M colony: PERF.md, PR 4.)
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
// What bounds it on the H100: memory traffic. The least the function must
// move is the occupancy plane and the 6 output planes of Z·Y·L f32 (7 ×
// 54.9 MB at the 1M-cell colony), plus position and radius of occupied
// slots with an occupied partner and velocity and spin of slots in
// contact. A settled colony (rest length 2.96 > contact reach 2.0) has no
// pair in contact, but every occupied slot screens all 62 variants (65M
// screens of ~21 instructions, most against empty partners, and no FMA may
// form), so the walk is bound by instruction issue and latency, and the
// sweep by the walk and the halo staging together (PERF.md, PR 4: the
// design measurements of tools/probe_contact_sweep.py).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kFields = 10;  // px py pz vx vy vz ox oy oz rad
constexpr int kStaged = 4;   // px py pz rad: the fields the screen reads
constexpr int kComps = 6;    // fx fy fz tx ty tz
constexpr int kThreads = 256;      // sweep block; two blocks per SM
constexpr int kWarps = kThreads / 32;
constexpr int kGateThreads = 256;  // gate block
constexpr int kLoads = 4;  // occupancy loads a thread has in flight
constexpr int kMaxWords = 1024;  // occupancy masks of a band (32K slots)

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

// Lanes staged beyond each end of a row: P = 2K − 1 rounded up to 4, so
// every copy is a multiple of 16 bytes (ops/contact.py `lane_pad`).
__host__ __device__ constexpr int lane_pad(int k) {
  return (2 * k - 1 + 3) / 4 * 4;
}

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

// Orders this thread's generic-proxy shared-memory writes before later
// bulk copies into the same buffer.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

// One band's staged halo: field f (px, py, pz, rad), plane z − 1 + p, row
// r0 − 1 + r, lane l + o lives at h[f·field + p·plane + r·run + kPad + l +
// o]; `own` is an own slot's index in that frame (p = 1). (No member is an
// array indexed at run time: that would put the struct on the stack and
// turn its shared-memory loads into generic ones.)
struct Halo {
  const float* h;
  int field, plane, run;

  __device__ __forceinline__ Own own_at(int own) const {
    return Own{h[own], h[field + own], h[2 * field + own],
               mul(h[3 * field + own], 0.5f)};
  }
  // The screen of variant (dz, dy, o) of own slot `own`.
  __device__ __forceinline__ Screen screen_at(const Own& c, int own, int dz,
                                              int dy, int o) const {
    const int q = own + dz * plane + dy * run + o;
    return screen(c, h[q], h[field + q], h[2 * field + q],
                  h[3 * field + q]);
  }
};

// The walk of one occupied own slot (halo index `own`; global slot i at
// z, y, l). Writes the slot's six sums where a pair is kept.
template <int K>
__device__ __forceinline__ void walk(const Halo& hs, int own, const Geom& g,
                                     int z, int y, int l, size_t i,
                                     const InFields& in, const OutComps& out,
                                     const Model& m) {
  using V = Variants<K>;
  const Own c = hs.own_at(own);
  // Pass 1: mark every variant whose pair the screen keeps.
  unsigned marks[V::kWords];
#pragma unroll
  for (int w = 0; w < V::kWords; ++w) marks[w] = 0u;
  V::each([&](int j, int dz, int dy, int o) {
    const Screen s = hs.screen_at(c, own, dz, dy, o);
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
      add_pair(acc, c, v, hs.screen_at(c, own, dz, dy, o), in,
               partner(g, z, y, l, dz, dy, o), m);
    }
  }
#pragma unroll
  for (int k = 0; k < kComps; ++k) out.c[k][i] = acc[k];
}

// The work buffer (int32, zeroed by the caller): [0] the listed bands,
// [1] the bands taken, then the band list and, per band, its occupancy as
// `words` 32-bit masks (bit i of word w: own slot 32·w + i; written for
// listed bands only). The host sizes it the same (ops/contact.py
// `work_ints`).
struct Work {
  int* w;
  int bands_all;  // Z · bands
  int words;      // band_rows · L / 32

  __device__ __forceinline__ int* list() const { return w + 2; }
  __device__ __forceinline__ unsigned* occupancy(int band) const {
    return reinterpret_cast<unsigned*>(w + 2 + bands_all) +
           static_cast<size_t>(band) * words;
  }
};

// Launch 1: one block per band. The block reads the band's occupancy into
// 32-bit masks (one coalesced load and a warp ballot per 32 slots, kLoads
// in flight). An empty band gets +0 in every output slot; a band with an
// occupied slot keeps its masks and joins the work list.
__global__ void __launch_bounds__(kGateThreads)
    contact_gate_kernel(const float* __restrict__ occ, OutComps out, Geom g,
                        int band_rows, int bands, Work work) {
  __shared__ unsigned masks[kMaxWords];
  const int band = blockIdx.x;
  const int z = band / bands, r0 = band % bands * band_rows;
  const int n_own = min(band_rows, g.Y - r0) * g.L;
  const size_t base = (static_cast<size_t>(z) * g.Y + r0) * g.L;
  bool any = false;
  for (int t0 = 0; t0 < n_own; t0 += kGateThreads * kLoads) {
    bool o[kLoads];
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int t = t0 + r * kGateThreads + threadIdx.x;
      o[r] = t < n_own && occ[base + t] > 0.5f;
    }
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const unsigned m = __ballot_sync(0xffffffffu, o[r]);
      const int t = t0 + r * kGateThreads + threadIdx.x;
      if ((threadIdx.x & 31) == 0 && t < n_own) masks[t >> 5] = m;
      any |= m != 0u;
    }
  }
  if (__syncthreads_or(any)) {
    unsigned* dst = work.occupancy(band);
    for (int w = threadIdx.x; w < n_own / 32; w += kGateThreads)
      dst[w] = masks[w];
    if (threadIdx.x == 0) work.list()[atomicAdd(&work.w[0], 1)] = band;
    return;
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int c = 0; c < kComps; ++c) {
    float4* dst = reinterpret_cast<float4*>(out.c[c] + base);
    for (int t = threadIdx.x; t < n_own / 4; t += kGateThreads) dst[t] = zero;
  }
}

// The sweep block's shared memory: the staged halo [4][3][band_rows +
// 2][run], the list of occupied own slots, the warp counts, the mbarrier
// and the next band's list index. The host computes the same bytes
// (ops/contact.py `band_plan`).
__host__ __device__ inline size_t halo_floats(int band_rows, int run) {
  return static_cast<size_t>(kStaged) * 3 * (band_rows + 2) * run;
}
__host__ __device__ inline size_t smem_bytes_of(int band_rows, int L,
                                                int run) {
  return 4 * (halo_floats(band_rows, run) +
              static_cast<size_t>(band_rows) * L + kWarps) +
         16;
}

// Launch 2, persistent: each block takes listed bands until the list runs
// out.
template <int K>
__global__ void __launch_bounds__(kThreads, 2)
    contact_band_kernel(InFields in, OutComps out, Geom g, int band_rows,
                        int bands, Model m, Work work) {
  constexpr int kPad = lane_pad(K);
  extern __shared__ __align__(128) unsigned char smem[];
  const int run = g.L + 2 * kPad;
  const int plane = (band_rows + 2) * run;
  const int field = 3 * plane;
  float* halo = reinterpret_cast<float*>(smem);
  int* list = reinterpret_cast<int*>(halo + halo_floats(band_rows, run));
  int* warp_count = list + band_rows * g.L;
  uint64_t* bar = reinterpret_cast<uint64_t*>(warp_count + kWarps);
  int* next = reinterpret_cast<int*>(bar + 1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int listed = work.w[0];
  const Halo hs{halo, field, plane, run};
  if (threadIdx.x == 0) {
    mbar_init(bar);
    *next = atomicAdd(&work.w[1], 1);
  }
  uint32_t phase = 0;
  for (;;) {
    // The last band's reads are done before its buffers are refilled, and
    // `next` (and, at first, the barrier's init) is visible.
    __syncthreads();
    const int idx = *next;
    if (idx >= listed) break;
    int following = 0;
    if (threadIdx.x == 0) following = atomicAdd(&work.w[1], 1);
    const int band = work.list()[idx];
    const int z = band / bands, r0 = band % bands * band_rows;
    const int rows = min(band_rows, g.Y - r0);
    const int n_own = rows * g.L;
    const size_t base = (static_cast<size_t>(z) * g.Y + r0) * g.L;

    // a. Stage px, py, pz, rad of planes z ± 1, rows r0 − 1 .. r0 + rows:
    // one copy per (field, plane, row), one per thread.
    const int copies = kStaged * 3 * (rows + 2);
    if (threadIdx.x == 0)
      mbar_expect_tx(bar, static_cast<uint32_t>(copies) *
                              static_cast<uint32_t>(g.L) * 4u);
    for (int t = threadIdx.x; t < copies; t += kThreads) {
      const int r = t % (rows + 2), p = t / (rows + 2) % 3,
                f = t / (rows + 2) / 3;
      const float* src = f == 0   ? in.f[0]
                         : f == 1 ? in.f[1]
                         : f == 2 ? in.f[2]
                                  : in.f[9];
      bulk_load(halo + f * field + p * plane + r * run + kPad,
                src + (static_cast<size_t>(wrap(z - 1 + p, g.Z)) * g.Y +
                       wrap(r0 - 1 + r, g.Y)) *
                          g.L,
                g.L * 4u, bar);
    }

    // b. +0 into the band's outputs, and the list of its occupied own
    // slots, in layout order, from the gate's masks (a warp prefix sum of
    // their popcounts), while the copies land.
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      float4* dst = reinterpret_cast<float4*>(out.c[c] + base);
      for (int t = threadIdx.x; t < n_own / 4; t += kThreads) dst[t] = zero;
    }
    const unsigned* masks = work.occupancy(band);
    int count = 0;
    for (int w0 = 0; w0 < n_own / 32; w0 += kThreads) {
      const int w = w0 + threadIdx.x;
      unsigned mk = w < n_own / 32 ? masks[w] : 0u;
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
      for (; mk != 0u; mk &= mk - 1u) list[before++] = w * 32 + __ffs(mk) - 1;
      __syncthreads();
      count += total;
    }

    // The lane pads of the staged rows, once they land: the row's last
    // kPad lanes to the left, its first kPad to the right (the plain
    // roll's wrap). The buffer is refilled by bulk copies later, hence the
    // proxy fence.
    mbar_wait(bar, phase);
    phase ^= 1u;
    for (int t = threadIdx.x; t < copies * 2 * kPad; t += kThreads) {
      const int i = t % (2 * kPad), row = t / (2 * kPad);
      float* r = halo + row / (rows + 2) * plane + row % (rows + 2) * run;
      if (i < kPad)
        r[i] = r[g.L + i];
      else
        r[g.L + i] = r[i];
    }
    fence_proxy_async();
    __syncthreads();

    // c. Walk the occupied own slots.
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const int own = list[t];
      const int ry = own / g.L, l = own - ry * g.L;
      walk<K>(hs, plane + (ry + 1) * run + kPad + l, g, z, r0 + ry,
                      l, base + own, in, out, m);
    }
    if (threadIdx.x == 0) *next = following;
  }
}

// Launches the gate and the sweep on `stream`; returns a cudaError_t value
// (0 on success).
template <int K>
int launch_k(const InFields& in, const float* occ, const OutComps& out,
             const Geom& g, int band_rows, int smem_bytes, const Model& m,
             int* work, cudaStream_t stream) {
  const int run = g.L + 2 * lane_pad(K);
  if (static_cast<size_t>(smem_bytes) != smem_bytes_of(band_rows, g.L, run))
    return cudaErrorInvalidValue;
  const int bands = (g.Y + band_rows - 1) / band_rows;
  const Work w{work, g.Z * bands, band_rows * g.L / 32};
  auto* kernel = contact_band_kernel<K>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (rc != cudaSuccess) return rc;
  int per_sm = 0, device = 0, sms = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                     kThreads, smem_bytes);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return rc;
  contact_gate_kernel<<<g.Z * bands, kGateThreads, 0, stream>>>(
      occ, out, g, band_rows, bands, w);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const int grid = std::min(per_sm * sms, w.bands_all);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(in, out, g, band_rows, bands,
                                                 m, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns a cudaError_t value (0 on success); nothing is synchronised.
// `band_rows` and `smem_bytes` come from ops/contact.py `band_plan`; a
// mismatch with the kernel's own layout returns cudaErrorInvalidValue.
// `work` is a zeroed int32 buffer of 2 + Z·bands·(1 + band_rows·L/32)
// entries. Built for K ∈ {1, 2, 4} (the repository's colony scenes);
// anything else is refused.
extern "C" int sph_contact_sweep(const void* const* fields, const float* occ,
                                 void* const* outs, int* work, int Z, int Y,
                                 int L, int K, int band_rows, int smem_bytes,
                                 float eps, float slip_eps,
                                 float repulsion, float torque_factor,
                                 float mult, void* stream) {
  InFields in;
  for (int i = 0; i < kFields; ++i) {
    in.f[i] = static_cast<const float*>(fields[i]);
  }
  OutComps out;
  for (int i = 0; i < kComps; ++i) out.c[i] = static_cast<float*>(outs[i]);
  const Model m{eps, slip_eps, repulsion, torque_factor, mult};
  const Geom g{Z, Y, L};
  const auto st = static_cast<cudaStream_t>(stream);
  if (Z < 1 || Y < 1 || L < 32 || L % 32 || band_rows < 1 ||
      band_rows * L > 32 * kMaxWords)
    return cudaErrorInvalidValue;
  switch (K) {
    case 1:
      return launch_k<1>(in, occ, out, g, band_rows, smem_bytes, m, work, st);
    case 2:
      return launch_k<2>(in, occ, out, g, band_rows, smem_bytes, m, work, st);
    case 4:
      return launch_k<4>(in, occ, out, g, band_rows, smem_bytes, m, work, st);
    default:
      return cudaErrorInvalidValue;
  }
}
