// Dense-grid pair sweeps for Hopper (sm_90a): K1 density and K2 pressure +
// viscosity acceleration.
//
// Replaces: the Pallas kernel `_newton_kernel` (sph_tpu/ops/pallas/fluid.py)
// as launched by `density_pallas` (K1) and `accel_pallas` (K2).
//
// Layout: every field is [n0, K, C] f32 (plane, slot, fused row·cell), C
// fastest, C = n1·X; empty slots hold sentinel positions (1e9), and one
// margin cell rings the domain, so a fused offset dy·X + dx that crosses a
// row boundary lands on a sentinel margin.
//
// Design: the work unit is a BAND, whole rows of one plane (the rows per
// band and the shared-memory bytes are chosen on the host, ops/fluid.py
// `band_plan`). Two launches on the caller's stream:
//  1. Gate (`band_gate_kernel`, one block per band). The block reads its
//     band's occupancy (16-byte loads), writes +0 to every output slot of
//     the band, and appends the band to a work list only when it holds an
//     occupied slot — the Pallas kernel's `pl.when` occupancy gate. About
//     82% of config[3]'s bands are empty and cost nothing more. For the
//     extent walk it also writes each cell's occupied EXTENT, 1 + its
//     highest occupied slot (0 when empty), into a uint8 [n0, C] plane.
//  2. Sweep (`band_sweep_kernel`, persistent: as many blocks as fit on the
//     card, each taking listed bands from an atomic counter). Per band:
//     a. Halo staging. One thread issues a TMA bulk copy (cp.async.bulk,
//        completed on an mbarrier) per (field, plane, slot) of the three
//        position fields: planes z−1, z, z+1 (z alone without a plane
//        stencil), the band's rows ±1 and 4 floats beyond each end (the
//        ±1-cell offsets that cross a row edge, rounded out to 16 bytes),
//        each one contiguous run of the fused axis, clipped to the array.
//        What the clip leaves out (and a plane outside the array) is
//        filled with the sentinel position, so no partner needs a bounds
//        test: its pair is screened out, as the plain version's wrapped
//        partner on a sentinel margin is. In the extent walk the threads
//        stage the same cells' extents beside them (0 where the clip
//        leaves a gap), a few hundred bytes a band.
//     b. Compaction, while the copies land: the band's occupied own slots
//        go to a list in shared memory (warp ballot + prefix sum), so that
//        every active lane of the walk has a particle.
//     c. Walk. Each thread takes occupied own slots from the list and
//        visits their partners in the order of the Newton-halved plain
//        version (`Stencil::each` below). The full walk (K ≤ 8) visits all
//        27·K − 1 (9·K − 1 in 2D), unrolled with the slot count and
//        stencil as compile-time constants, so every partner's
//        shared-memory offset and summation target are fixed at compile
//        time. The extent walk (K = 16, `kExtentWalk`) visits the own cell
//        so too, and each other cell's slots below E, the largest extent
//        among the warp's lanes for that cell (K for a lane whose own
//        position is not finite), in a loop of E steps that is the same
//        for every lane: a rebin leaves a cell's particles in its first
//        slots, so inside config[3]'s fluid (~5 particles a cell of 16
//        slots) a warp screens ~40% of the 431 partners.
//  Bit-exact screen. For each partner the thread forms r² from the staged
//  positions with the pair term's own operations. K1 skips the term
//  exactly when h² − r² ≤ 0 (it is then max(h² − r², 0)³ = +0), else adds
//  it at once. K2 runs two passes: the first marks, in a register bitmask,
//  every partner with r² ≤ r2_cut (or r² = +inf, or NaN); the second walks
//  each lane's own marks in order, skips a partner when h − r ≤ 0 with
//  r = r²·rsqrtf(max(r², 1e-18)) as the term computes it, and only then
//  loads the partner's other five fields (vx, vy, vz, ρ, p/ρ²) from
//  global memory; 1/ρ is __frcp_rn(ρ), the correctly rounded reciprocal
//  that torch.reciprocal gives on the card, so no separate 1/ρ pass is
//  needed. r2_cut = h²·(1 + 2⁻¹⁶) rounded up (ops/fluid.py
//  `accel_r2_cut`): rsqrtf errs by at most 2 ulp, so for finite
//  r² > r2_cut the term's r exceeds h·(1 + 2⁻¹⁷)(1 − 2⁻²¹) > h and h − r
//  ≤ 0 — the first pass never drops a pair the second would keep. So the
//  lanes of a warp run the full K2 term together about max-over-lanes
//  (~15–30) times instead of at every partner where any lane needs it.
//  Every test is written so that NaN fails it and takes the full term, as
//  in the plain version.
//
// Why the skip keeps the bits: every accumulator (the sum, its mirror
// lumps and parts) starts at +0 (the density sum at its positive self
// term) and a round-to-nearest sum that starts at +0 never becomes −0.
// A skipped term is ±0 for finite fields: K1's is max(h² − r², 0)³ = 0,
// K2's carries the factor max(h − r, 0) = 0 in both its pressure and its
// viscosity part. Adding ±0 to a nonzero sum leaves it unchanged, adding
// it to +0 gives +0, and folding a lump that stayed +0 changes nothing —
// so the second K2 pass folds a lump or part only when a surviving term
// moves past it (`Folds`). The extent walk leaves out only partner slots
// at or above the warp's extent E of their cell, so at or above the lane's
// own: they are empty, so they hold the sentinel position, and against a
// finite own position the pair is one the screen drops (r² ≈ 1e18 ≫ h²);
// leaving it out drops the same ±0 and never reaches the sums, whose
// terms it visits in the run's own order (the slots below E, rotated to
// start where the run meets them). The extent is the highest occupied
// slot + 1, not a count, so a cell with a hole (which no rebin leaves)
// walks too many slots, never too few; a lane whose own position is not
// finite walks every slot, so its NaN terms against empty partners stay
// in its sum as in the plain version. This holds for every layout whose
// empty slots hold the sentinel position, as `pack`, the rebins and F1
// leave them. What the skip hides from non-finite input: a partner outside
// h with a non-finite velocity, 1/ρ or p/ρ² (the plain version carries it
// in as NaN·0), and anything on an empty own slot, which is written +0.
// Non-finite positions are not hidden: they make r² NaN or +inf, which
// both screens keep, and the clamps here pass NaN as torch.clamp does.
//
// Summation order: the thread visits its partners in the order in which
// the Newton-halved plain version (`_sweep_plain` + `combine_mirror_parts`,
// sph_tpu_torch/sph/dense.py, the JAX twin's order) accumulates them for
// this slot: the forward terms of groups A, B, C, D, with the A and B
// mirror lumps folded in after their group, then the row part and the
// three plane parts. A mirror term the plain version computes on the
// partner's lane is the exact negation (accel) or the exact value
// (density) of the term computed here, so every partial sum is the same
// float. Every operation is an explicitly rounded intrinsic (__fadd_rn,
// __fmul_rn, ...), so nvcc forms no FMA, and the direction uses rsqrtf, as
// torch.rsqrt does on the card: K1 and K2 then match their plain versions
// bit for bit on occupied slots. (A reordered or FMA-contracted sum does
// not: the pressure terms cancel to ~1% of their size.)
//
// What bounds it on the H100: the least traffic is the occupancy plane
// and the output planes (2 or 4 × 35.6 MB at config[3] with K = 8); the
// full walk is 27·K − 1 screens per occupied slot (215 at K = 8, 431 at
// K = 16; 3 shared loads, ~10 operations each), plus the full terms of
// the partners inside h (~1 in 15 at K = 8), and is latency-bound at one
// block an SM. No FMA may be formed, so each screen costs 9
// floating-point instructions where 7 would do. The extent walk screens
// ~40% of the 431 at config[3] (`ops.fluid.sweep_screens`), in loop steps
// that cost more than the unrolled screens (the slot's offset and its
// wrap are computed, and the loop has a branch).
//
// ptxas (sm_90a, -O3): 62–64 registers per sweep kernel at K ≤ 8 (two
// blocks of 512 threads per SM cap it at 64); the 3D (K = 8) K2 kernel
// spills 92 bytes; the gate kernels take 31–32 (34–40 where they write
// extents). At K = 16 (one block an SM, 14 mark words) the extent walk
// takes 69 registers (79 for the 3D K2 kernel) and spills nothing.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 512;      // sweep block; two blocks per SM
constexpr int kWarps = kThreads / 32;
constexpr int kGateThreads = 256;  // gate block
constexpr int kPad = 4;    // floats staged beyond each end of a band's rows
constexpr int kLoads = 4;  // occupancy loads a thread has in flight
constexpr float kSentinel = 1.0e9f;  // sph/dense.py SENTINEL

struct Geom {
  int n0;  // planes
  int c;   // fused row·cell length
  int x;   // row length (fused stride of one row)
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
// torch.clamp_min semantics (NaN passes through).
__device__ __forceinline__ float at_least(float x, float lo) {
  return x < lo ? lo : x;
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

// Orders this thread's generic-proxy shared-memory writes before later
// bulk copies into the same buffer.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The partners of an own slot (z, k, c) in the order of the Newton-halved
// plain version: f(j, dz, dy, dx, sel, lump, part) for partner j, which
// lies in plane z + dz, slot (k + sel) mod K, cell c + dy·X + dx, and is
// summed into mirror lump `lump` (0: straight into the sum), which folds
// into `part` (0: into the sum). Every loop unrolls, so all arguments are
// compile-time constants at each call. Lump and part ids are unique.
template <int K, int S0>
struct Stencil {
  static constexpr int kPartners = 9 * (1 + 2 * S0) * K - 1;
  static constexpr int kWords = (kPartners + 31) / 32;
  static constexpr int kCells = 9 * (1 + 2 * S0);

  template <class F>
  __device__ __forceinline__ static void each(F&& f) {
    constexpr int H = K / 2;
    int j = 0;
    // Group A, the own cell: forward m in [1, K/2]; mirror lump m < K/2.
#pragma unroll
    for (int m = 1; m <= H; ++m) f(j++, 0, 0, 0, m, 0, 0);
#pragma unroll
    for (int m = 1; m < H; ++m) f(j++, 0, 0, 0, K - m, 1, 0);
    // Group B: the next cell of the row; its mirror lump, the previous.
#pragma unroll
    for (int m = 0; m < K; ++m) f(j++, 0, 0, 1, m, 0, 0);
#pragma unroll
    for (int m = 0; m < K; ++m) f(j++, 0, 0, -1, (K - m) % K, 2, 0);
    // Group C forward: the next row.
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx)
#pragma unroll
      for (int m = 0; m < K; ++m) f(j++, 0, 1, dx, m, 0, 0);
    // Group D forward: the next plane.
    if (S0) {
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx)
#pragma unroll
          for (int m = 0; m < K; ++m) f(j++, 1, dy, dx, m, 0, 0);
    }
    // The row part: one lump per dx of the previous row.
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx)
#pragma unroll
      for (int m = 0; m < K; ++m) f(j++, 0, -1, -dx, (K - m) % K, 4 + dx, 1);
    // The plane parts: one part per dy, one lump per dx, previous plane.
    if (S0) {
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx)
#pragma unroll
          for (int m = 0; m < K; ++m)
            f(j++, -1, -dy, -dx, (K - m) % K, 10 + 3 * dy + dx, 3 + dy);
    }
  }

  // The same partners a cell at a time, for the extent walk: run(dz, dy,
  // dx, m_lo, m_hi, mirror, lump, part, j0) for the partners m in [m_lo,
  // m_hi) of one cell, at sel = m (forward) or (K − m) mod K (mirror),
  // which are partners j0 + m − m_lo of `each`.
  template <class R>
  __device__ __forceinline__ static void runs(R&& run) {
    constexpr int H = K / 2;
    run(0, 0, 0, 1, H + 1, false, 0, 0, 0);
    run(0, 0, 0, 1, H, true, 1, 0, H);
    run(0, 0, 1, 0, K, false, 0, 0, K - 1);
    run(0, 0, -1, 0, K, true, 2, 0, 2 * K - 1);
    int j = 3 * K - 1;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx, j += K)
      run(0, 1, dx, 0, K, false, 0, 0, j);
    if (S0) {
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx, j += K)
          run(1, dy, dx, 0, K, false, 0, 0, j);
    }
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx, j += K)
      run(0, -1, -dx, 0, K, true, 4 + dx, 1, j);
    if (S0) {
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx, j += K)
          run(-1, -dy, -dx, 0, K, true, 10 + 3 * dy + dx, 3 + dy, j);
    }
  }
};

// The running sum with its open mirror lump and part, folded as
// combine_mirror_parts folds them: entering a term of another lump folds
// the open lump into its part (or the sum), entering another part folds
// the open part into the sum. With compile-time ids every test folds away.
template <int NC>
struct Folds {
  float acc[NC], part[NC], lump[NC];
  int cur_lump = 0, cur_part = 0;

  __device__ __forceinline__ explicit Folds(float first) {
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] = part[i] = lump[i] = 0.0f;
    acc[0] = first;
  }
  __device__ __forceinline__ void enter(int l, int p) {
    if (l != cur_lump) {
      if (cur_lump != 0) {
        if (cur_part != 0) {
#pragma unroll
          for (int i = 0; i < NC; ++i) part[i] = add(part[i], lump[i]);
        } else {
#pragma unroll
          for (int i = 0; i < NC; ++i) acc[i] = add(acc[i], lump[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) lump[i] = 0.0f;
      cur_lump = l;
    }
    if (p != cur_part) {
      if (cur_part != 0) {
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[i] = add(acc[i], part[i]);
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) part[i] = 0.0f;
      cur_part = p;
    }
  }
  __device__ __forceinline__ void add_term(const float* t) {
    if (cur_lump != 0) {
#pragma unroll
      for (int i = 0; i < NC; ++i) lump[i] = add(lump[i], t[i]);
    } else {
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] = add(acc[i], t[i]);
    }
  }
  __device__ __forceinline__ void finish() { enter(0, 0); }
};

// The staged positions of one band: partner (plane z + dz, slot s, fused
// cell cq) lives at x/y/z[(dz + S0)·krun + s·run + cq − lo].
// The extent of cell cq of plane z + dz at ext[(dz + S0)·run + cq − lo].
struct Staged {
  const float *x, *y, *z;
  const unsigned char* ext;
  const int4* table;  // per partner j: {staged offset, global offset, ids}
  int run, krun;
  int lo;             // fused index of each run's first float
};

// False for NaN and ±inf in any coordinate.
__device__ __forceinline__ bool finite3(float a, float b, float c) {
  const float inf = __int_as_float(0x7f800000);
  return fabsf(a) < inf && fabsf(b) < inf && fabsf(c) < inf;
}

// An own slot's view of the staged band: the staged offset of partner
// (dz, sel, dy, dx). K is a power of two, so the partner's slot is
// (k + sel) & (K − 1), computed per partner so that K offsets do not take
// registers from the 64 a thread has.
template <int K, int S0>
struct OwnView {
  int k;       // own slot
  int cell;    // c − lo
  int x;       // row stride

  __device__ __forceinline__ OwnView(const Staged& s, int k_, int c, int x_)
      : k(k_), cell(c - s.lo), x(x_) {}
  __device__ __forceinline__ int at(const Staged& s, int dz, int dy, int dx,
                                    int sel) const {
    return (dz + S0) * s.krun + ((k + sel) & (K - 1)) * s.run + cell +
           dy * x + dx;
  }
  // The staged offset of slot 0 of cell (dz, dy, dx).
  __device__ __forceinline__ int base(const Staged& s, int dz, int dy,
                                      int dx) const {
    return (dz + S0) * s.krun + cell + dy * x + dx;
  }
  // The extent of cell (dz, dy, dx).
  __device__ __forceinline__ int extent(const Staged& s, int dz, int dy,
                                        int dx) const {
    return s.ext[(dz + S0) * s.run + cell + dy * x + dx];
  }
};

// What the extent walk knows of the 27 (9) partner cells of a warp's own
// slots: the largest extent among the lanes, per cell, as a mask of the
// slots below it, 32 / K cells a word. A lane whose own position is not
// finite counts every slot of every cell.
template <int K, int S0>
struct Extents {
  static constexpr int kPer = 32 / K;
  static constexpr int kN = (Stencil<K, S0>::kCells + kPer - 1) / kPer;
  unsigned below[kN];

  __device__ __forceinline__ Extents(const Staged& s, const OwnView<K, S0>& v,
                                     bool finite) {
    const unsigned lanes = __activemask();
    const unsigned all = finite ? 0u : ~0u;
#pragma unroll
    for (int w = 0; w < kN; ++w) {
      unsigned word = 0u;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int ci = w * kPer + i;
        if (ci < Stencil<K, S0>::kCells) {
          const int e = v.extent(s, ci / 9 - S0, ci / 3 % 3 - 1, ci % 3 - 1);
          word |= ((((1u << e) - 1u) | all) & ((1u << K) - 1u)) << (K * i);
        }
      }
      below[w] = __reduce_or_sync(lanes, word);
    }
  }
  // The warp's extent of cell (dz, dy, dx).
  __device__ __forceinline__ int of(int dz, int dy, int dx) const {
    const int ci = (dz + S0) * 9 + (dy + 1) * 3 + dx + 1;
    return __popc((below[ci / kPer] >> (K * (ci % kPer))) & ((1u << K) - 1u));
  }
};

// The extent walk of one run of a cell whose warp extent is E: its live
// slots in the run's order, U at a time. A forward run (slot (k + m) mod
// K for m = 0, 1, ...) meets the slots below E from k upwards, wrapping to
// 0 at E (from 0 when k ≥ E); a mirror run (slot (k − m) mod K) from
// min(k, E − 1) downwards, wrapping to E − 1. chunk(q, m, n) takes U
// staged offsets, their partners' m and how many of them are live.
template <int K, int U, class C>
__device__ __forceinline__ void walk_run(int base, int run, int k, int E,
                                         bool mirror, C&& chunk) {
  int sl = mirror ? min(k, E - 1) : (k < E ? k : 0);
  for (int i = 0; i < E; i += U) {
    int q[U], m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      q[u] = base + sl * run;
      m[u] = (mirror ? k - sl : sl - k) & (K - 1);
      sl = mirror ? (sl == 0 ? E - 1 : sl - 1) : (sl + 1 == E ? 0 : sl + 1);
    }
    chunk(q, m, min(U, E - i));
  }
}

__device__ __forceinline__ float dist2(float ddx, float ddy, float ddz) {
  return add(add(mul(ddx, ddx), mul(ddy, ddy)), mul(ddz, ddz));
}

struct DensitySweep {
  const float* occ;
  float* out;
  float h2, self_init, scale;

  __device__ __forceinline__ void zero4(size_t i) const {
    *reinterpret_cast<float4*>(out + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  template <int K, int S0>
  __device__ __forceinline__ void build_table(int4*, int, const Geom&,
                                              int) const {}

  template <int K, int S0, bool kExtents>
  __device__ __forceinline__ void own(const Staged& s, const Geom& g, int z,
                                      int k, int c, int i) const {
    const OwnView<K, S0> v(s, k, c, g.x);
    const int o = v.at(s, 0, 0, 0, 0);
    const float cx = s.x[o], cy = s.y[o], cz = s.z[o];
    Folds<1> f(self_init);
    // density_pair_term: t = max(h² − r², 0); t·t·t, of the partner at q.
    const auto u_of = [&](int q) {
      return sub(h2, dist2(sub(cx, s.x[q]), sub(cy, s.y[q]),
                           sub(cz, s.z[q])));
    };
    const auto add_pair = [&](float u) {
      if (u <= 0.0f) return;  // the term is max(u, 0)³ = +0
      // Here u > 0 or NaN, so max(u, 0) = u as torch.clamp_min gives it.
      const float t = mul(mul(u, u), u);
      f.add_term(&t);
    };
    if (kExtents) {
      const Extents<K, S0> ext(s, v, finite3(cx, cy, cz));
      Stencil<K, S0>::runs([&](int dz, int dy, int dx, int m_lo, int m_hi,
                               bool mirror, int l, int p, int) {
        f.enter(l, p);
        if (dz == 0 && dy == 0 && dx == 0) {  // the own cell: every slot
#pragma unroll
          for (int m = m_lo; m < m_hi; ++m)
            add_pair(u_of(v.at(s, 0, 0, 0, mirror ? K - m : m)));
          return;
        }
        walk_run<K, 4>(v.base(s, dz, dy, dx), s.run, k, ext.of(dz, dy, dx),
                       mirror, [&](const int* q, const int*, int n) {
                         float u[4];
#pragma unroll
                         for (int j = 0; j < 4; ++j) u[j] = u_of(q[j]);
#pragma unroll
                         for (int j = 0; j < 4; ++j)
                           if (j < n) add_pair(u[j]);
                       });
      });
    } else {
      Stencil<K, S0>::each([&](int, int dz, int dy, int dx, int sel, int l,
                               int p) {
        f.enter(l, p);
        add_pair(u_of(v.at(s, dz, dy, dx, sel)));
      });
    }
    f.finish();
    out[i] = mul(scale, f.acc[0]);
  }
};

struct AccelSweep {
  const float *vx, *vy, *vz, *rho, *pr2;
  const float* occ;
  float *ax, *ay, *az;
  float h, neg_m_spiky, visc_mc, r2_cut;

  __device__ __forceinline__ void zero4(size_t i) const {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(ax + i) = zero;
    *reinterpret_cast<float4*>(ay + i) = zero;
    *reinterpret_cast<float4*>(az + i) = zero;
  }

  // The partner table of the second pass: lane `lane` of one warp writes
  // the entries j ≡ lane (mod 32).
  template <int K, int S0>
  __device__ __forceinline__ void build_table(int4* table, int lane,
                                              const Geom& g, int krun) const {
    Stencil<K, S0>::each([&](int j, int dz, int dy, int dx, int sel, int l,
                             int p) {
      if ((j & 31) == lane)
        table[j] = make_int4((dz + S0) * krun + dy * g.x + dx,
                             dz * K * g.c + dy * g.x + dx,
                             sel | l << 8 | p << 16, 0);
    });
  }

  template <int K, int S0, bool kExtents>
  __device__ __forceinline__ void own(const Staged& s, const Geom& g, int z,
                                      int k, int c, int i) const {
    using St = Stencil<K, S0>;
    const OwnView<K, S0> v(s, k, c, g.x);
    const int o = v.at(s, 0, 0, 0, 0);
    const float cx = s.x[o], cy = s.y[o], cz = s.z[o];
    const float inf = __int_as_float(0x7f800000);

    // Pass 1: mark the partners the r² screen keeps; the extent walk never
    // reaches, so never marks, a slot at or above its cell's extent.
    unsigned marks[St::kWords];
#pragma unroll
    for (int w = 0; w < St::kWords; ++w) marks[w] = 0u;
    const auto kept = [&](int q) {
      const float r2 = dist2(sub(cx, s.x[q]), sub(cy, s.y[q]),
                             sub(cz, s.z[q]));
      return !(r2 > r2_cut && r2 < inf);  // else h − r ≤ 0: a ±0 term
    };
    if (kExtents) {
      const Extents<K, S0> ext(s, v, finite3(cx, cy, cz));
      St::runs([&](int dz, int dy, int dx, int m_lo, int m_hi, bool mirror,
                   int, int, int j0) {
        unsigned bits = 0u;  // bit m − m_lo: partner j0 + m − m_lo kept
        if (dz == 0 && dy == 0 && dx == 0) {  // the own cell: every slot
#pragma unroll
          for (int m = m_lo; m < m_hi; ++m)
            if (kept(v.at(s, 0, 0, 0, mirror ? K - m : m)))
              bits |= 1u << (m - m_lo);
        } else {
          walk_run<K, 1>(v.base(s, dz, dy, dx), s.run, k,
                         ext.of(dz, dy, dx), mirror,
                         [&](const int* q, const int* m, int) {
                           if (kept(q[0])) bits |= 1u << m[0];
                         });
        }
        marks[j0 >> 5] |= bits << (j0 & 31);
        if ((j0 & 31) + m_hi - m_lo > 32)
          marks[(j0 >> 5) + 1] |= bits >> (32 - (j0 & 31));
      });
    } else {
      St::each([&](int j, int dz, int dy, int dx, int sel, int, int) {
        if (kept(v.at(s, dz, dy, dx, sel))) marks[j >> 5] |= 1u << (j & 31);
      });
    }

    // Pass 2: this lane's marks in order, with the exact screen and the
    // full term (accel_pair_terms, operation for operation).
    const float cvx = vx[i], cvy = vy[i], cvz = vz[i];
    const float cirho = __frcp_rn(rho[i]), cpr2 = pr2[i];
    const float r2_floor = static_cast<float>(1e-18);
    const float self_r2 = static_cast<float>(1e-16);
    const int own_g = z * K * g.c + c;
    const int last = g.n0 * K * g.c - 1;
    Folds<3> f(0.0f);
    int w = 0;
    unsigned b = marks[0];
    for (;;) {
      while (b == 0u && w + 1 < St::kWords) {
        ++w;
#pragma unroll
        for (int q = 1; q < St::kWords; ++q)
          if (q == w) b = marks[q];
      }
      if (b == 0u) break;
      const int j = w * 32 + __ffs(b) - 1;
      b &= b - 1u;
      const int4 e = s.table[j];
      const int sl = (k + (e.z & 0xff)) & (K - 1);
      const int q = sl * s.run + v.cell + e.x;
      const float ddx = sub(cx, s.x[q]);
      const float ddy = sub(cy, s.y[q]);
      const float ddz = sub(cz, s.z[q]);
      const float r2 = dist2(ddx, ddy, ddz);
      const float rinv = rsqrtf(at_least(r2, r2_floor));
      const float r = mul(r2, rinv);
      const float hr = sub(h, r);
      if (hr <= 0.0f) continue;  // max(h − r, 0) = 0 zeroes the term
      // Here hr > 0 or NaN, so max(hr, 0) = hr as torch.clamp_min gives it.
      // (The clamp only keeps a NaN own slot on the array's margin, whose
      // every term is NaN, from reading outside the fields.)
      const int jg = min(max(sl * g.c + own_g + e.y, 0), last);
      const float not_self = r2 > self_r2 ? 1.0f : 0.0f;
      const float hrm = mul(hr, not_self);
      const float cp = mul(mul(mul(mul(neg_m_spiky, hrm), hr), rinv),
                           add(cpr2, pr2[jg]));
      const float cv =
          mul(mul(visc_mc, hrm), mul(cirho, __frcp_rn(rho[jg])));
      float t[3];
      t[0] = add(mul(cp, ddx), mul(cv, sub(vx[jg], cvx)));
      t[1] = add(mul(cp, ddy), mul(cv, sub(vy[jg], cvy)));
      t[2] = add(mul(cp, ddz), mul(cv, sub(vz[jg], cvz)));
      f.enter((e.z >> 8) & 0xff, e.z >> 16);
      f.add_term(t);
    }
    f.finish();
    ax[i] = f.acc[0];
    ay[i] = f.acc[1];
    az[i] = f.acc[2];
  }
};

// The extent of a cell whose occupied slots are the set bits of `bits`.
__device__ __forceinline__ unsigned extent(unsigned bits) {
  return 32 - __clz(bits);  // __clz(0) = 32
}

// Launch 1: one block per band. +0 into every output slot of the band;
// the band joins the work list (work[2 + n], n = work[0]++) when it holds
// an occupied slot. For the extent walk it also writes each cell's extent
// into ext [n0, C], gathering its cells' occupied slots as bits in shared
// memory, 16 a cell (K ≤ 16) and two cells a word: rows·X·2 bytes.
template <class Sweep, bool kExtents>
__global__ void __launch_bounds__(kGateThreads)
    band_gate_kernel(Sweep sw, Geom g, int k, int band_rows, int bands,
                     unsigned char* __restrict__ ext, int* __restrict__ work) {
  extern __shared__ unsigned slot_bits[];
  const int band = blockIdx.x;
  const int z = band / bands, r0 = band % bands * band_rows;
  const int per4 = min(band_rows, g.c / g.x - r0) * g.x / 4;
  if (kExtents) {
    for (int t = threadIdx.x; t < 2 * per4; t += kGateThreads)
      slot_bits[t] = 0u;
    __syncthreads();
  }
  bool any = false;
  for (int t = threadIdx.x; t < k * per4; t += kGateThreads) {
    const int slot = t / per4, q = t % per4;
    const size_t i = (static_cast<size_t>(z) * k + slot) * g.c + r0 * g.x +
                     q * 4;
    const float4 o = *reinterpret_cast<const float4*>(sw.occ + i);
    const unsigned lo = (o.x > 0.5f ? 1u : 0u) | (o.y > 0.5f ? 1u << 16 : 0u);
    const unsigned hi = (o.z > 0.5f ? 1u : 0u) | (o.w > 0.5f ? 1u << 16 : 0u);
    if (kExtents && lo) atomicOr(&slot_bits[2 * q], lo << slot);
    if (kExtents && hi) atomicOr(&slot_bits[2 * q + 1], hi << slot);
    any |= (lo | hi) != 0u;
    sw.zero4(i);
  }
  if (__syncthreads_or(any) && threadIdx.x == 0)
    work[2 + atomicAdd(&work[0], 1)] = band;
  for (int q = threadIdx.x; kExtents && q < per4; q += kGateThreads) {
    const unsigned a = slot_bits[2 * q], b = slot_bits[2 * q + 1];
    *reinterpret_cast<uchar4*>(ext + static_cast<size_t>(z) * g.c +
                               r0 * g.x + q * 4) =
        make_uchar4(extent(a & 0xffffu), extent(a >> 16),
                    extent(b & 0xffffu), extent(b >> 16));
  }
}

// The sweep block's shared memory: the partner table, the staged
// positions [3][P][K][run], the list of occupied own slots, the warp
// counts, the mbarrier, the next band's list index and the staged extents
// [P][run] (bytes). The host computes the same bytes (ops/fluid.py
// `band_plan`).
struct Layout {
  int planes;    // P = 1 + 2·S0
  int run;       // floats per (field, plane, slot): (rows + 2)·X + 2·kPad
  int own;       // own slots of a full band: K·rows·X
  int slots;     // K
  int partners;  // table entries
  __host__ __device__ size_t field_floats() const {
    return static_cast<size_t>(planes) * slots * run;
  }
  __host__ __device__ size_t pos_floats() const { return 3 * field_floats(); }
  bool extents;  // the extent walk stages [P][run] extents (bytes)
  __host__ __device__ size_t bytes() const {
    return 16 * static_cast<size_t>(partners) +
           4 * (pos_floats() + own + kLoads * kWarps) + 16 +
           (extents ? static_cast<size_t>(planes) * run : 0);
  }
};

// Blocks an SM the sweep is built for: two at K ≤ 8 (64 registers a
// thread); one at K = 16, whose one-row band alone needs more than half an
// SM's shared memory (ops/fluid.py `band_plan`), so a thread may take 128
// registers — K2's pass-1 marks are 14 words there.
template <int K>
constexpr int kMinBlocks = K > 8 ? 1 : 2;

// The walk follows the blocks an SM. With one block (16 warps) an SM the
// full walk's 431 screens a slot are latency-bound, and the extent walk,
// though each of its steps costs more than an unrolled screen, saves more
// than that inside config[3]'s fluid (~5 particles a cell of 16 slots).
// With two blocks an SM the full walk of 8 slots a cell hides its latency,
// and the extent walk lost at every 8-slot layout measured, even where the
// cells were sparse (PERF.md).
template <int K>
constexpr bool kExtentWalk = kMinBlocks<K> == 1;

// Launch 2, persistent: each block takes listed bands until the list runs
// out (work[1] counts the bands taken).
template <class Sweep, int K, int S0>
__global__ void __launch_bounds__(kThreads, kMinBlocks<K>)
    band_sweep_kernel(Sweep sw, const float* __restrict__ px,
                      const float* __restrict__ py,
                      const float* __restrict__ pz,
                      const unsigned char* __restrict__ ext, Geom g,
                      int band_rows, int bands, Layout lay,
                      int* __restrict__ work) {
  constexpr bool kExtents = kExtentWalk<K>;
  extern __shared__ __align__(128) unsigned char smem[];
  int4* table = reinterpret_cast<int4*>(smem);
  float* pos = reinterpret_cast<float*>(table + lay.partners);
  int* list = reinterpret_cast<int*>(pos + lay.pos_floats());
  int* warp_count = list + lay.own;
  uint64_t* bar = reinterpret_cast<uint64_t*>(warp_count + kLoads * kWarps);
  int* next = reinterpret_cast<int*>(bar + 1);
  uint32_t* ext_words = reinterpret_cast<uint32_t*>(bar + 2);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int listed = work[0];
  const int n1 = g.c / g.x;
  const size_t field = lay.field_floats();
  const int krun = K * lay.run;
  const Staged s{pos, pos + field, pos + 2 * field,
                 reinterpret_cast<const unsigned char*>(ext_words),
                 table, lay.run, krun, 0};
  if (threadIdx.x == 0) {
    mbar_init(bar);
    *next = atomicAdd(&work[1], 1);
  }
  if (warp == 0) sw.template build_table<K, S0>(table, lane, g, krun);
  uint32_t phase = 0;
  for (;;) {
    // The last band's reads are done before its buffers are refilled, and
    // `next` (and, at first, the barrier's init and the table) is visible.
    __syncthreads();
    const int idx = *next;
    if (idx >= listed) break;
    int following = 0;
    if (threadIdx.x == 0) following = atomicAdd(&work[1], 1);
    const int band = work[2 + idx];
    const int z = band / bands, r0 = band % bands * band_rows;
    const int per_slot = min(band_rows, n1 - r0) * g.x;
    const int n_own = K * per_slot;
    const int lo = (r0 - 1) * g.x - kPad;
    const int a = max(lo, 0), e = min(lo + lay.run, g.c);

    // a. Stage the positions of planes z ± S0, rows r0 − 1 .. r0 + B + 1.
    if (threadIdx.x == 0) {
      const int zlo = max(z - S0, 0), zhi = min(z + S0, g.n0 - 1);
      const uint32_t bytes = static_cast<uint32_t>(e - a) * 4u;
      mbar_expect_tx(bar, bytes * 3u * K * (zhi - zlo + 1));
      const float* src[3] = {px, py, pz};
      for (int f = 0; f < 3; ++f)
        for (int zq = zlo; zq <= zhi; ++zq)
          for (int slot = 0; slot < K; ++slot)
            bulk_load(pos + f * field +
                          ((zq - z + S0) * K + slot) * lay.run + (a - lo),
                      src[f] + (static_cast<size_t>(zq) * K + slot) * g.c + a,
                      bytes, bar);
    }
    // The sentinel where the clip (or the array's end plane) left a gap.
    const bool edge = z - S0 < 0 || z + S0 >= g.n0 || a > lo ||
                      e < lo + lay.run;
    if (edge) {
      for (int t = threadIdx.x; t < static_cast<int>(lay.pos_floats());
           t += kThreads) {
        const int r = t % lay.run;
        const int zq = z - S0 + t / lay.run / K % lay.planes;
        if (zq < 0 || zq >= g.n0 || r < a - lo || r >= e - lo)
          pos[t] = kSentinel;
      }
    }

    // The extents of the same cells, 4 at a time: a, e and lo are
    // multiples of 4, so a word lies wholly inside the clip or outside it.
    for (int t = threadIdx.x; kExtents && t < lay.planes * lay.run / 4;
         t += kThreads) {
      const int zq = z - S0 + t / (lay.run / 4);
      const int r = t % (lay.run / 4) * 4;
      ext_words[t] = zq >= 0 && zq < g.n0 && r >= a - lo && r < e - lo
                         ? *reinterpret_cast<const uint32_t*>(
                               ext + static_cast<size_t>(zq) * g.c + lo + r)
                         : 0u;
    }

    // b. Compact the occupied own slots, in layout order, while the
    // copies land; each thread has kLoads loads in flight at once.
    int count = 0;
    for (int t0 = 0; t0 < n_own; t0 += kThreads * kLoads) {
      bool occupied[kLoads];
      unsigned ballot[kLoads];
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int t = t0 + r * kThreads + threadIdx.x;
        occupied[r] = t < n_own &&
                      sw.occ[(z * K + t / per_slot) * g.c + r0 * g.x +
                             t % per_slot] > 0.5f;
        ballot[r] = __ballot_sync(0xffffffffu, occupied[r]);
        if (lane == 0) warp_count[r * kWarps + warp] = __popc(ballot[r]);
      }
      __syncthreads();
      int total = 0;
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        int before = count + total;
        for (int w = 0; w < kWarps; ++w) {
          before += w < warp ? warp_count[r * kWarps + w] : 0;
          total += warp_count[r * kWarps + w];
        }
        if (occupied[r])
          list[before + __popc(ballot[r] & ((1u << lane) - 1u))] =
              t0 + r * kThreads + threadIdx.x;
      }
      __syncthreads();
      count += total;
    }
    mbar_wait(bar, phase);
    phase ^= 1u;

    // c. Walk the occupied own slots.
    Staged sb = s;
    sb.lo = lo;
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const int own = list[t];
      const int k = own / per_slot;
      const int c = r0 * g.x + own % per_slot;
      sw.template own<K, S0, kExtents>(sb, g, z, k, c, (z * K + k) * g.c + c);
    }
    if (edge) fence_proxy_async();
    if (threadIdx.x == 0) *next = following;
  }
}

// Launches the gate and the sweep on `stream`; returns a cudaError_t value
// (0 on success).
template <class Sweep, int K, int S0>
int launch_ks(const Sweep& sw, const float* px, const float* py,
              const float* pz, const Geom& g, int band_rows, int smem_bytes,
              unsigned char* ext, int* work, cudaStream_t stream) {
  constexpr bool kExtents = kExtentWalk<K>;
  const Layout lay{1 + 2 * S0, (band_rows + 2) * g.x + 2 * kPad,
                   K * band_rows * g.x, K, Stencil<K, S0>::kPartners,
                   kExtents};
  if (static_cast<size_t>(smem_bytes) != lay.bytes())
    return cudaErrorInvalidValue;
  const int bands = (g.c / g.x + band_rows - 1) / band_rows;
  auto* kernel = band_sweep_kernel<Sweep, K, S0>;
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
  band_gate_kernel<Sweep, kExtents>
      <<<g.n0 * bands, kGateThreads, kExtents ? 2 * band_rows * g.x : 0,
         stream>>>(sw, g, K, band_rows, bands, ext, work);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const int grid = std::min(per_sm * sms, g.n0 * bands);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(sw, px, py, pz, ext, g,
                                                 band_rows, bands, lay, work);
  return static_cast<int>(cudaGetLastError());
}

// The kernels are built for the repository's scenes: K = 8 with a plane
// stencil (3D), K = 4 without (2D), K = 16 (config[3], whose cells are
// sought by more than 8 particles at a rebin), and the other pairings; every
// stencil has rows (S1 = 1). Anything else is refused.
template <class Sweep>
int launch(const Sweep& sw, const float* px, const float* py,
           const float* pz, int n0, int k, int c, int x, int stencil0,
           int stencil1, int band_rows, int smem_bytes, unsigned char* ext,
           int* work, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const Geom g{n0, c, x};
  if (x % kPad || c % x || band_rows < 1 || !stencil1)
    return cudaErrorInvalidValue;
  const int key = k * 2 + (stencil0 ? 1 : 0);
  switch (key) {
    case 16 * 2 + 1:
      return launch_ks<Sweep, 16, 1>(sw, px, py, pz, g, band_rows,
                                     smem_bytes, ext, work, st);
    case 16 * 2:
      return launch_ks<Sweep, 16, 0>(sw, px, py, pz, g, band_rows,
                                     smem_bytes, ext, work, st);
    case 8 * 2 + 1:
      return launch_ks<Sweep, 8, 1>(sw, px, py, pz, g, band_rows,
                                    smem_bytes, ext, work, st);
    case 8 * 2:
      return launch_ks<Sweep, 8, 0>(sw, px, py, pz, g, band_rows,
                                    smem_bytes, ext, work, st);
    case 4 * 2 + 1:
      return launch_ks<Sweep, 4, 1>(sw, px, py, pz, g, band_rows,
                                    smem_bytes, ext, work, st);
    case 4 * 2:
      return launch_ks<Sweep, 4, 0>(sw, px, py, pz, g, band_rows,
                                    smem_bytes, ext, work, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns a cudaError_t value (0 on success); nothing is synchronised.
// `band_rows` and `smem_bytes` come from ops/fluid.py `band_plan`; a
// mismatch with the kernel's own layout returns cudaErrorInvalidValue.
// `work` is a zeroed int32 buffer of 2 + n0·bands entries; `ext`, where
// the build walks extents (K = 16), a uint8 scratch plane of n0·c bytes
// that the gate fills.

extern "C" int sph_density_sweep(const float* px, const float* py,
                                 const float* pz, const float* occ,
                                 float* out, int* work, unsigned char* ext,
                                 int n0, int k, int c,
                                 int x, int stencil0, int stencil1,
                                 int band_rows, int smem_bytes, float h2,
                                 float self_init, float scale, void* stream) {
  const DensitySweep sw{occ, out, h2, self_init, scale};
  return launch(sw, px, py, pz, n0, k, c, x, stencil0, stencil1, band_rows,
                smem_bytes, ext, work, stream);
}

extern "C" int sph_accel_sweep(const float* px, const float* py,
                               const float* pz, const float* vx,
                               const float* vy, const float* vz,
                               const float* rho, const float* pr2,
                               const float* occ, float* ax, float* ay,
                               float* az, int* work, unsigned char* ext,
                               int n0, int k, int c,
                               int x, int stencil0, int stencil1,
                               int band_rows, int smem_bytes, float h,
                               float neg_m_spiky, float visc_mc,
                               float r2_cut, void* stream) {
  const AccelSweep sw{vx, vy, vz, rho, pr2, occ, ax, ay, az,
                      h, neg_m_spiky, visc_mc, r2_cut};
  return launch(sw, px, py, pz, n0, k, c, x, stencil0, stencil1, band_rows,
                smem_bytes, ext, work, stream);
}
