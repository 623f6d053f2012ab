// The dense-grid rebin for Hopper (sm_90a): K3.
//
// Replaces: the Pallas kernel `_stage_kernel` (sph_tpu/ops/pallas/rebin.py)
// as launched by `_run_stage` from `rebin_pallas` — three launches, one per
// layout axis in the order in-row cells, rows, planes — together with the
// sentinel cleanup `rebin_pallas` runs after them.
//
// What it computes: bitwise the plain `rebin` of sph_tpu_torch/sph/dense.py
// (on positions, velocities and occupancy bitwise the JAX twin, which leaves
// ρ and p in the slots they were in; here they move with their particle),
// ±0 aside — the plain version's masked sums turn −0 into +0 where the
// kernel copies bits. The staged rebin moves each
// particle at most one cell per stage: stage 2 gathers, into every cell, the
// ≤ 3K occupied candidates of itself and its in-row neighbours x−1, x, x+1
// (shift-major: neighbour, then slot) whose bin coordinate on that axis,
//     clip(trunc((p − origin) / cell), lo, hi)      (IEEE f32 divide)
// is the cell's own, keeps the first K and counts the rest in `dropped`, as
// it counts own-cell particles whose coordinate is more than one cell away;
// stage 1 then does the same over rows, stage 0 over planes. Empty slots of
// the result hold sentinel positions, zero velocity, pressure and
// occupancy, and the rest density.
//
// Why one pass can do it: positions do not change between the stages, which
// only copy, so each particle's move per axis — −1, 0, +1 or "far" — can be
// coded once. The staged result of cell (z, r, x) is then one ordered walk
// over its 27 source cells (z+a, r+b, x+c): planes a = −1, 0, 1, then rows
// b, then in-row c, then source slot k, with three counters:
//   r2 counts candidates with dx = −c; it restarts at each (a, b), and a
//      candidate survives stage 2 while r2 < K;
//   r1 counts stage-2 survivors with dy = −b; it restarts at each a, and a
//      survivor passes stage 1 while r1 < K;
//   r0 counts stage-1 survivors with dz = −a: each lands in slot r0 while
//      r0 < K.
// This is `_compact_stage`'s shift-major order with its truncation at every
// stage. Every drop is counted once, by the cell that owns it: stage-2 drops
// and far-x particles of cell (z', r', x) by that cell's walk at a = b = 0;
// stage-1 drops and far-y particles of (z', r, x) by that cell's walk at
// a = 0; stage-0 drops and far-z particles by the final cell. 2D has no
// plane stage: its plane move codes 0 and never truncates. (Every spec
// has a row stage: `make_dense_spec` gives each axis at least 3 cells.)
//
// The margin invariant. Neighbours are read by fused index: c ± 1 for the
// in-row shift (which, like the plain version's roll of the fused axis,
// crosses into the next row at a row's end) and c ± X for rows; cells
// outside the array read as empty, where the plain version rolls. Both
// readings agree because the cells at coordinate 0 and n − 1 of every axis
// with a stage never hold a particle: `pack` and `bin_coord` clip every
// coordinate to the interior [1, n − 2].
//
// Design: two launches on the caller's stream.
//  1. Codes (`rebin_codes_kernel`, one thread per cell, cells fastest):
//     reads the occupancy plane and the positions of occupied slots and
//     writes one byte per slot — 0 if empty, else 0x40 | ez<<4 | ey<<2 | ex,
//     each e = delta + 1 or 3 for far — as one K-byte word per cell
//     ([Z, C] words of 32, 64 or 128 bits), so an empty cell is one zero
//     word. It also copies the
//     state's `dropped` into the fresh count the placement adds to.
//  2. Placement (`rebin_place_kernel`, one thread per final cell, 256
//     consecutive fused cells of one plane a block): the block stages its
//     code halo (planes ±1, fused offsets ±(X + 1)) in shared memory with
//     coalesced loads; a block whose halo is all zero writes its fill and
//     ends. Each thread walks its 27 source words; an empty one costs one
//     test. For the others, byte-parallel masks (`match`) pick the slots
//     each stage wants; when no counter would pass K inside the word, the
//     counters advance by population counts and only the slots that land
//     here are visited; otherwise the word is walked slot by slot. The
//     source of each placed slot (neighbour and slot) is 8 bits (K ≤ 8) or
//     16 bits (K = 16) of 64-bit registers (`Sources`). Then the thread
//     writes its K slots of all 9 planes
//     once, slot by slot, so a warp's stores are 128-byte runs: the 8
//     payload fields (position, velocity, ρ, p) copied from the source
//     slot, occupancy 1, and the sentinel / 0 / ρ0 / 0 / 0 fill in the
//     rest. No array or struct member is
//     indexed at run time, so nothing lives on the stack. `dropped` is
//     summed with one integer atomicAdd per thread that dropped anything:
//     integer addition is order-free, so the count is deterministic.
//     The walk also counts, before each stage's truncation, how many
//     particles sought this cell at that stage (the `wants` of the plain
//     `_compact_stage`); the largest over the stages goes to a running
//     `demand` peak by one atomicMax a warp (max is order-free too).
//
// Numerics: no FMA can form (subtract, then divide with __fdiv_rn), and the
// quotient is clamped to [lo, hi] before the conversion: a C cast of an
// out-of-range float (sentinel lanes give ~1e9) is undefined, and for
// integer bounds clamp-then-truncate equals truncate-then-clip.
//
// What bounds it on the H100: memory traffic. The 9 output planes (9·4·Z·K·C
// bytes, 681 MB at config[3]'s [154, 16, 7680]) are written once and the
// occupancy plane read once; the positions and payload of occupied slots
// are read once each by the codes pass and the placement. The code words
// (Z·C·K bytes, 8.9 MB) stay in L2 between the launches.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr float kSentinel = 1.0e9f;
constexpr unsigned kOccupied = 0x40u;
constexpr unsigned kFar = 3u;

// One K-byte code word per cell: 32, 64 or 128 bits.
using u128 = unsigned __int128;
template <int K>
using Word = typename std::conditional<
    K == 16, u128,
    typename std::conditional<K == 8, uint64_t, uint32_t>::type>::type;

__device__ __forceinline__ int lowest_set_byte(uint32_t w) {
  return (__ffs(static_cast<int>(w)) - 1) >> 3;
}
__device__ __forceinline__ int lowest_set_byte(uint64_t w) {
  return (__ffsll(static_cast<long long>(w)) - 1) >> 3;
}
__device__ __forceinline__ int lowest_set_byte(u128 w) {
  const uint64_t lo = static_cast<uint64_t>(w);
  return lo ? lowest_set_byte(lo)
            : 8 + lowest_set_byte(static_cast<uint64_t>(w >> 64));
}

__device__ __forceinline__ int popc(uint32_t w) { return __popc(w); }
__device__ __forceinline__ int popc(uint64_t w) { return __popcll(w); }
__device__ __forceinline__ int popc(u128 w) {
  return __popcll(static_cast<uint64_t>(w)) +
         __popcll(static_cast<uint64_t>(w >> 64));
}

// 0x01 in every byte of W.
template <typename W>
__device__ __forceinline__ W byte_ones() {
  W ones = 0;
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(W)); ++i) ones = ones << 8 | 1u;
  return ones;
}

// Byte-parallel tests on a code word (each byte ≤ 0x7f): 0x80 in every
// byte whose bits `mask` equal `want`, 0 elsewhere — exact, with no carry
// between bytes.
template <typename W>
__device__ __forceinline__ W match(W w, unsigned mask, unsigned want) {
  const W ones = byte_ones<W>();
  const W low7 = ones * 0x7fu;
  const W y = (w & (ones * mask)) ^ (ones * want);
  return ~(((y & low7) + low7) | y | low7);
}

// One layout axis: its origin and the interior [lo, hi] of its cells.
struct Axis {
  float origin;
  int lo;
  int hi;
};

// The move code of one coordinate: delta + 1 for |delta| ≤ 1, else kFar.
__device__ __forceinline__ unsigned move_code(float p, Axis ax, float cell,
                                              int own) {
  const float q = __fdiv_rn(__fsub_rn(p, ax.origin), cell);
  const int t = static_cast<int>(fminf(fmaxf(q, static_cast<float>(ax.lo)),
                                       static_cast<float>(ax.hi)));
  const int d = t - own;
  return (d >= -1 && d <= 1) ? static_cast<unsigned>(d + 1) : kFar;
}

template <int K, bool kPlanes>
__global__ void __launch_bounds__(kThreads)
    rebin_codes_kernel(const float* __restrict__ p0,
                       const float* __restrict__ p1,
                       const float* __restrict__ p2,
                       const float* __restrict__ occ,
                       Word<K>* __restrict__ codes,
                       const int* __restrict__ dropped_in,
                       int* __restrict__ dropped, int n0, int c, int x,
                       Axis a0, Axis a1, Axis a2, float cell) {
  const int cell_id = blockIdx.x * kThreads + threadIdx.x;
  if (cell_id == 0) *dropped = *dropped_in;  // the placement adds to it
  if (cell_id >= n0 * c) return;
  const int z = cell_id / c;
  const int cc = cell_id - z * c;
  const int r = cc / x;
  const int xx = cc - r * x;
  Word<K> w = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = (z * K + k) * c + cc;
    if (!(occ[j] > 0.5f)) continue;
    unsigned code = kOccupied | move_code(p2[j], a2, cell, xx);
    code |= move_code(p1[j], a1, cell, r) << 2;
    code |= (kPlanes ? move_code(p0[j], a0, cell, z) : 1u) << 4;
    w |= static_cast<Word<K>>(code) << (8 * k);
  }
  codes[cell_id] = w;
}

struct Payload {
  const float* px;
  const float* py;
  const float* pz;
  const float* vx;
  const float* vy;
  const float* vz;
  const float* rho;
  const float* prs;
};

struct Planes {
  float* px;
  float* py;
  float* pz;
  float* vx;
  float* vy;
  float* vz;
  float* rho;
  float* prs;
  float* occ;
  float rest;  // ρ of an empty slot, as the density pass leaves it
};

__device__ __forceinline__ void write_fill(const Planes& out, int o) {
  out.px[o] = kSentinel;
  out.py[o] = kSentinel;
  out.pz[o] = kSentinel;
  out.vx[o] = 0.0f;
  out.vy[o] = 0.0f;
  out.vz[o] = 0.0f;
  out.rho[o] = out.rest;
  out.prs[o] = 0.0f;
  out.occ[o] = 0.0f;
}

// The source of each placed slot, (neighbour << kSlotBits | slot), in
// kBits bits of up to four 64-bit registers (one at K ≤ 8). put() runs
// with the slot counter, get() with a compile-time slot; the registers are
// named, not an array, so none is indexed at run time.
template <int K>
struct Sources {
  static constexpr int kSlotBits = K > 8 ? 4 : 3;
  static constexpr int kBits = K > 8 ? 16 : 8;   // 27 neighbours · K slots
  uint64_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;

  __device__ __forceinline__ void put(int r, int nb, int slot) {
    const int bit = r * kBits;
    const uint64_t v = static_cast<uint64_t>(nb << kSlotBits | slot)
                       << (bit & 63);
    if (K * kBits <= 64 || bit < 64) {
      w0 |= v;
    } else if (bit < 128) {
      w1 |= v;
    } else if (bit < 192) {
      w2 |= v;
    } else {
      w3 |= v;
    }
  }
  __device__ __forceinline__ int get(int s) const {
    const int bit = s * kBits;
    const uint64_t w = bit < 64 ? w0 : bit < 128 ? w1 : bit < 192 ? w2 : w3;
    return static_cast<int>(w >> (bit & 63)) & ((1 << kBits) - 1);
  }
};

template <int K, bool kPlanes>
__global__ void __launch_bounds__(kThreads)
    rebin_place_kernel(Payload in, Planes out,
                       const Word<K>* __restrict__ codes,
                       int* __restrict__ dropped, int* __restrict__ demand,
                       int n0, int c, int x) {
  using W = Word<K>;
  extern __shared__ __align__(16) unsigned char smem[];
  W* halo = reinterpret_cast<W*>(smem);
  constexpr int kHaloPlanes = kPlanes ? 3 : 1;
  const int h = x + 1;  // the halo's half-width along the fused axis
  const int width = kThreads + 2 * h;
  const int z = blockIdx.y;
  const int c0 = blockIdx.x * kThreads;
  const int t = threadIdx.x;
  bool any = false;
  for (int i = t; i < kHaloPlanes * width; i += kThreads) {
    const int p = i / width;
    const int zz = z + p - (kPlanes ? 1 : 0);
    const int ci = c0 - h + (i - p * width);
    W v = 0;
    if (zz >= 0 && zz < n0 && ci >= 0 && ci < c) v = codes[zz * c + ci];
    halo[i] = v;
    any |= v != 0;
  }
  const bool live = __syncthreads_or(any);
  const int cc = c0 + t;
  if (cc >= c) return;
  const int base = z * K * c + cc;
  if (!live) {
#pragma unroll
    for (int s = 0; s < K; ++s) write_fill(out, base + s * c);
    return;
  }

  // The walk: planes a, rows b, in-row c, then source slot. d2, d1, d0
  // count what each stage's cell here was sought by before its truncation
  // (stage 2 at a = b = 0, stage 1 at a = 0, stage 0 over the whole walk).
  Sources<K> srcs;
  int r0 = 0, drops = 0, d2 = 0, d1 = 0, d0 = 0;
#pragma unroll
  for (int a = kPlanes ? -1 : 0; a <= (kPlanes ? 1 : 0); ++a) {
    int r1 = 0;
#pragma unroll
    for (int b = -1; b <= 1; ++b) {
      int r2 = 0;
#pragma unroll
      for (int dc = -1; dc <= 1; ++dc) {
        const int nb = (a + 1) * 9 + (b + 1) * 3 + (dc + 1);
        const W w = halo[(kPlanes ? a + 1 : 0) * width + h + t + b * x + dc];
        if (!w) continue;
        // Byte masks (0x80 per slot): m2 the candidates of stage 2, m1 of
        // those the ones stage 1 wants here, m0 of those stage 0's.
        const W m2 = match(w, 0x43u, kOccupied | (1 - dc));
        const W m1 = m2 & match(w, 0x4cu, kOccupied | (1 - b) << 2);
        const W m0 = kPlanes ? m1 & match(w, 0x70u, kOccupied | (1 - a) << 4)
                             : m1;
        if (r2 + popc(m2) <= K && r1 + popc(m1) <= K &&
            r0 + popc(m0) <= K) {
          // No stage truncates inside this word: count by masks, place m0.
          if (a == 0 && b == 0 && dc == 0) {
            drops += popc(match(w, 0x43u, 0x43u));  // far in-row
          }
          if (a == 0 && b == 0) {
            drops += popc(m2 & match(w, 0x4cu, 0x4cu));  // far rows
          }
          if (kPlanes && a == 0) {
            drops += popc(m1 & match(w, 0x70u, 0x70u));  // far planes
          }
          if (a == 0 && b == 0) d2 += popc(m2);
          if (a == 0) d1 += popc(m1);
          if (kPlanes) d0 += popc(m0);
          r2 += popc(m2);
          r1 += popc(m1);
          for (W m = m0; m; m &= m - 1) {
            srcs.put(r0, nb, lowest_set_byte(m));
            ++r0;
          }
          continue;
        }
        // A stage truncates: walk the word's slots one by one.
        for (W rest = w; rest;) {
          const int k = lowest_set_byte(rest);
          const unsigned code = static_cast<unsigned>(rest >> (8 * k)) & 0xffu;
          rest &= ~(static_cast<W>(0xffu) << (8 * k));
          const unsigned ex = code & 3u;
          if (a == 0 && b == 0 && dc == 0 && ex == kFar) ++drops;
          if (ex != static_cast<unsigned>(1 - dc)) continue;
          if (a == 0 && b == 0) ++d2;
          if (r2 >= K) {  // stage 2 overflows cell (z+a, r+b, x)
            if (a == 0 && b == 0) ++drops;
            continue;
          }
          ++r2;
          const unsigned ey = (code >> 2) & 3u;
          if (a == 0 && b == 0 && ey == kFar) ++drops;
          if (ey != static_cast<unsigned>(1 - b)) continue;
          if (a == 0) ++d1;
          if (r1 >= K) {  // stage 1 overflows cell (z+a, r, x)
            if (a == 0) ++drops;
            continue;
          }
          ++r1;
          if (kPlanes) {
            const unsigned ez = (code >> 4) & 3u;
            if (a == 0 && ez == kFar) ++drops;
            if (ez != static_cast<unsigned>(1 - a)) continue;
            ++d0;
            if (r0 >= K) {  // stage 0 overflows this cell
              ++drops;
              continue;
            }
          }
          srcs.put(r0, nb, k);
          ++r0;
        }
      }
    }
  }

  // Each output slot once, slot by slot: the source's payload or the fill.
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int o = base + s * c;
    if (s < r0) {
      const int src = srcs.get(s);
      const int nb = src >> Sources<K>::kSlotBits;
      const int a = nb / 9 - 1;
      const int b = (nb / 3) % 3 - 1;
      const int dc = nb % 3 - 1;
      const int j = base + (a * K + (src & (K - 1))) * c + b * x + dc;
      const float px = __ldg(in.px + j), py = __ldg(in.py + j);
      const float pz = __ldg(in.pz + j), vx = __ldg(in.vx + j);
      const float vy = __ldg(in.vy + j), vz = __ldg(in.vz + j);
      const float rho = __ldg(in.rho + j), prs = __ldg(in.prs + j);
      out.px[o] = px;
      out.py[o] = py;
      out.pz[o] = pz;
      out.vx[o] = vx;
      out.vy[o] = vy;
      out.vz[o] = vz;
      out.rho[o] = rho;
      out.prs[o] = prs;
      out.occ[o] = 1.0f;
    } else {
      write_fill(out, o);
    }
  }
  if (drops) atomicAdd(dropped, drops);
  // The demand peak: one atomicMax a converged group of lanes.
  int peak = max(d0, max(d1, d2));
  const unsigned lanes = __activemask();
  peak = __reduce_max_sync(lanes, peak);
  if ((threadIdx.x & 31) == __ffs(lanes) - 1 && peak > 0)
    atomicMax(demand, peak);
}

int halo_bytes(int k, bool planes, int x) {
  return (planes ? 3 : 1) * (kThreads + 2 * (x + 1)) * k;
}

template <int K, bool kPlanes>
int launch_codes(const float* p0, const float* p1, const float* p2,
                 const float* occ, void* codes, const int* dropped_in,
                 int* dropped, int n0, int c, int x, Axis a0, Axis a1,
                 Axis a2, float cell, cudaStream_t s) {
  const int cells = n0 * c;
  rebin_codes_kernel<K, kPlanes>
      <<<(cells + kThreads - 1) / kThreads, kThreads, 0, s>>>(
          p0, p1, p2, occ, static_cast<Word<K>*>(codes), dropped_in, dropped,
          n0, c, x, a0, a1, a2, cell);
  return static_cast<int>(cudaGetLastError());
}

template <int K, bool kPlanes>
int launch_place(const Payload& in, const Planes& out, const void* codes,
                 int* dropped, int* demand, int n0, int c, int x,
                 cudaStream_t s) {
  const int smem = halo_bytes(K, kPlanes, x);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rebin_place_kernel<K, kPlanes>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((c + kThreads - 1) / kThreads, n0);
  rebin_place_kernel<K, kPlanes><<<grid, kThreads, smem, s>>>(
      in, out, static_cast<const Word<K>*>(codes), dropped, demand, n0, c,
      x);
  return static_cast<int>(cudaGetLastError());
}

// Instantiates F<K, planes>(args...) for K ∈ {4, 8, 16} and both flags.
#define SPH_REBIN_DISPATCH(F, k, planes, ...)                     \
  ((k) == 16 ? ((planes) ? F<16, true>(__VA_ARGS__)                \
                         : F<16, false>(__VA_ARGS__))              \
   : (k) == 8 ? ((planes) ? F<8, true>(__VA_ARGS__)                \
                          : F<8, false>(__VA_ARGS__))              \
              : ((planes) ? F<4, true>(__VA_ARGS__)                \
                          : F<4, false>(__VA_ARGS__)))

bool built_for(int k) { return k == 4 || k == 8 || k == 16; }

Axis axis(float origin, int n) {
  const int lo = n - 1 < 1 ? n - 1 : 1;
  const int hi = n - 2 > lo ? n - 2 : lo;
  return Axis{origin, lo, hi};
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches one kernel on
// `stream` and returns a cudaError_t value (0 on success); nothing is
// synchronised. Layout [n0, k, c] f32 with rows of x cells (c = n1·x);
// `planes` says whether the plane stage runs (the spec's stencil0); k must
// be 4, 8 or 16.

// Pass 1: p0, p1, p2 are the position fields of layout axes 0, 1, 2 (the
// spec's axis_map) with their origins; `codes` receives n0·c words of k
// bytes, and the int `dropped` the state's count `dropped_in`, to which
// pass 2 adds.
extern "C" int sph_rebin_codes(const float* p0, const float* p1,
                               const float* p2, const float* occ, void* codes,
                               const int* dropped_in, int* dropped, int n0,
                               int k, int c, int x, int planes, float origin0,
                               float origin1, float origin2, float cell,
                               void* stream) {
  if (!built_for(k) || x < 1 || c % x != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return SPH_REBIN_DISPATCH(launch_codes, k, planes, p0, p1, p2, occ, codes,
                            dropped_in, dropped, n0, c, x, axis(origin0, n0),
                            axis(origin1, c / x), axis(origin2, x), cell,
                            static_cast<cudaStream_t>(stream));
}

// Pass 2: `in` holds 8 device pointers (px, py, pz, vx, vy, vz, rho, prs),
// `out` 9 (the same and occ), all fresh; `rest` is the ρ an empty slot
// gets; `dropped` is pass 1's count, added to; the int `demand` is raised
// (atomicMax) to the most particles that sought one cell at any stage of
// this rebin.
extern "C" int sph_rebin_place(const float* const* in, float* const* out,
                               const void* codes, int* dropped, int* demand,
                               int n0, int k, int c, int x, int planes,
                               float rest, void* stream) {
  if (!built_for(k) || x < 1 || c % x != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Payload pin{in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7]};
  const Planes pout{out[0], out[1], out[2], out[3], out[4],
                    out[5], out[6], out[7], out[8], rest};
  return SPH_REBIN_DISPATCH(launch_place, k, planes, pin, pout, codes,
                            dropped, demand, n0, c, x,
                            static_cast<cudaStream_t>(stream));
}
