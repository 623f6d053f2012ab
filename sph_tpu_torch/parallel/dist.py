"""Spatial domain decomposition over torch.distributed ranks (BASELINE
config[4]) — the counterpart of sph_tpu.parallel.dist.

A mesh is a world of ranks, one process per shard (`Mesh`; the launcher is
`parallel.launch.spawn`). The dense fluid layout [N0, K, C = Y·X] is
sharded over layout dim 0 (world x planes) across a 1D ring of ranks, or
over dim 0 and the row blocks of the fused axis (world y) across a 2D
(pz × py) mesh; the colony's contact sweep over the z planes (1D) or the z
planes and y rows (2D) of its [Z, Y, X·K] layout. Each fluid step exchanges
one-plane / one-row halos with the ring neighbours (point-to-point sends
and receives, all four of an exchange posted together, so a ring of two,
whose forward and backward peer are one rank, cannot deadlock). 2D corner
cells arrive transitively: rows are padded first, then planes, so the plane
exchange ships row-padded boundary planes. The colony's pack is replicated,
so each rank cuts its halo-padded block from it (`contact_block`) with no
exchange; `cut_block` is that mesh-free cut, which `shard_dense_state` and
`fluid_slab` use too.

Why the result is bitwise the single-device run's: the unsharded engine's
rolls wrap around dim 0 into the sentinel margin ring, and under a wrapping
ring of ranks the first rank's left halo is the last rank's last plane —
the global right margin, i.e. sentinel. Interior planes see the same
neighbour planes as on one device; the kernels sum in their plain order
whatever the slab's size, and the elementwise passes do not depend on it.

Per step: 3 exchanges of the fluid (positions and occupancy for density;
v, ρ, p for forces; the post-integration state for the rebin, on rebin
steps), each field's 2 boundary planes (and in 2D first its 2 boundary
rows) in one message each way. The rebin on a halo-padded slab is always
the plain `dense.rebin` (never K3): K3 fetches planes ±1 clamped to the
array, which is inert only when the edge planes are sentinel margins; here
they are real halo data (sph_tpu/parallel/dist.py:140-149).

Backends are the caller's choice (`spawn`): nccl for one card per rank,
where the halos travel card to card; gloo for ranks on the CPU and for
ranks that share one card. Gloo's point-to-point takes CPU tensors only, so
with CUDA tensors every message is staged through pinned host buffers, and
the mesh counts those bytes and their copy time (`Mesh.stats`). Nothing
here switches backend or device, or a kernel for its plain version, by
itself.

Differences from the JAX module: no jit or shard_map — each rank steps its
own block, a host loop of substeps that decides the rebin cadence from the
host's step count, as `dense.make_dense_step` does; the padding of an
uneven n0 (and, in 2D, n1) happens in `shard_dense_state` and is cut in
`unshard_dense_state`, not inside the step; counters are summed over the
whole mesh (JAX sums over both axes of a 2D mesh, which is the same). The
mesh always spans the whole world of ranks.
"""

from __future__ import annotations

import dataclasses
import socket
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from sph_tpu_torch.ops import obstacle_pushed
from sph_tpu_torch.sph import dense
from sph_tpu_torch.sph.dense import DenseFluidState, DenseSpec
from sph_tpu_torch.sph.model import SPHParams

# The per-slot fields of a DenseFluidState (the counters are replicated).
FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "occ", "rho", "prs")
MOVED = ("px", "py", "pz", "vx", "vy", "vz")


@dataclass(frozen=True)
class RankInfo:
    """A rank as the mesh builders order it: its global rank and the index
    of its host — the roles a TPU device's id and slice_index play in the
    JAX package's device-order policy."""

    rank: int
    node: int | None = None


def world_ranks() -> list[RankInfo]:
    """Every rank of the default process group with its node (hosts
    numbered in the order of their first rank). Collective."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    nodes: dict[str, int] = {}
    return [RankInfo(r, nodes.setdefault(n, len(nodes)))
            for r, n in enumerate(names)]


def order_devices_slice_major(devices=None) -> list:
    """The seam policy shared by make_multislice_mesh and make_mesh_2d:
    stable sort by (node, rank). Ranks of one host then hold one
    contiguous run of slabs, so a 1D halo ring crosses between hosts once
    per adjacent host pair (plus the wraparound hop), and a 2D (pz, py)
    row-major reshape keeps each py-row on one host whenever py divides
    the ranks per host. One host: a stable no-op (rank order). `devices`:
    RankInfo-like objects (`rank`, `node`); default every rank of the
    world (collective)."""
    devices = list(world_ranks() if devices is None else devices)
    devices.sort(key=lambda d: (d.node or 0, d.rank))
    return devices


class Mesh:
    """A grid of torch.distributed ranks, one process per shard: the 1D
    ring ("x",) or the 2D (z, y) mesh of the sharded steps. Every rank of
    the world builds it alike (the mesh spans the world). It holds the rank
    grid, this rank's coordinates and ring neighbours along each axis, its
    device (default: the current CUDA device) and the exchange counters.

    Exchanges and reductions run on the default process group, addressed
    by global rank; a ring of one rank is its own neighbour, as ppermute
    over an axis of size 1 is."""

    def __init__(self, ranks, axis_names, device=None):
        grid = np.vectorize(lambda r: getattr(r, "rank", r),
                            otypes=[np.int64])(np.asarray(ranks, object))
        if grid.ndim != len(axis_names) or grid.ndim not in (1, 2):
            raise ValueError(f"a {grid.ndim}-D grid of ranks with axis "
                             f"names {tuple(axis_names)}")
        world = dist.get_world_size()
        if sorted(grid.flat) != list(range(world)):
            raise ValueError(f"the mesh {grid.tolist()} must hold every "
                             f"rank of the world of {world} once")
        self.ranks = grid
        self.axis_names = tuple(axis_names)
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.coords = tuple(int(c) for c in np.argwhere(grid == self.rank)[0])
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.neighbours = []
        for axis, n in enumerate(grid.shape):
            peer = []
            for step in (-1, 1):
                c = list(self.coords)
                c[axis] = (c[axis] + step) % n
                peer.append(int(grid[tuple(c)]))
            self.neighbours.append(tuple(peer))        # (backward, forward)
        # Gloo moves CPU tensors only: CUDA tensors go through host copies.
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.stats = {"halo_bytes": 0, "staged_bytes": 0, "staging_s": 0.0,
                      "messages": 0}

    @property
    def shape(self) -> tuple[int, ...]:
        return self.ranks.shape

    @property
    def ndim(self) -> int:
        return self.ranks.ndim

    @property
    def size(self) -> int:
        return self.ranks.size

    def axis(self, name: str | None) -> int:
        return 0 if name is None else self.axis_names.index(name)

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0

    # -- the wire: CUDA tensors through pinned host buffers under gloo ------

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if not self.staged:
            return t
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self.stats["staging_s"] += time.perf_counter() - t0
        self.stats["staged_bytes"] += h.nbytes
        return h

    def _from_wire(self, h: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return h
        t0 = time.perf_counter()
        t = h.to(self.device)
        self.stats["staging_s"] += time.perf_counter() - t0
        self.stats["staged_bytes"] += h.nbytes
        return t

    @staticmethod
    def _buffer_like(w: torch.Tensor) -> torch.Tensor:
        return torch.empty(w.shape, dtype=w.dtype, device=w.device,
                           pin_memory=w.is_pinned())

    def ring_exchange(self, axis: int, to_fwd: torch.Tensor,
                      to_bwd: torch.Tensor):
        """Send `to_fwd` to the next rank along `axis` and `to_bwd` to the
        previous one; returns (from_bwd, from_fwd): what the previous rank
        sent forward and what the next rank sent backward. The four
        transfers are posted together, with a tag per direction."""
        bwd, fwd = self.neighbours[axis]
        if bwd == fwd == self.rank:
            return to_fwd, to_bwd
        a, b = self._to_wire(to_fwd), self._to_wire(to_bwd)
        ra, rb = self._buffer_like(a), self._buffer_like(b)
        ops = [dist.P2POp(dist.isend, a, fwd, tag=2 * axis),
               dist.P2POp(dist.isend, b, bwd, tag=2 * axis + 1),
               dist.P2POp(dist.irecv, ra, bwd, tag=2 * axis),
               dist.P2POp(dist.irecv, rb, fwd, tag=2 * axis + 1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.stats["halo_bytes"] += a.nbytes + b.nbytes
        self.stats["messages"] += 2
        return self._from_wire(ra), self._from_wire(rb)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        """`t` reduced over every rank (a new tensor on t's device)."""
        w = self._to_wire(t)
        if w is t:
            w = t.clone()
        dist.all_reduce(w, op=op)
        return self._from_wire(w).to(t.device)

    def all_gather_blocks(self, t: torch.Tensor, dims: tuple[int, ...]):
        """Every rank's block `t` (the same shape on all) put together in
        mesh order: axis a of the mesh runs along dim dims[a] of `t`."""
        w = self._to_wire(t)
        outs = [self._buffer_like(w) for _ in range(self.size)]
        dist.all_gather(outs, w)
        blocks = [self._from_wire(o) for o in outs]
        if self.ndim == 1:
            return torch.cat([blocks[r] for r in self.ranks], dim=dims[0])
        return torch.cat([
            torch.cat([blocks[r] for r in row], dim=dims[1])
            for row in self.ranks], dim=dims[0])

    def barrier(self) -> None:
        dist.barrier()


def make_multislice_mesh(devices=None, axis_name: str = "x",
                         device=None) -> Mesh:
    """1D slab ring ordered host-major (order_devices_slice_major):
    consecutive slabs stay on one host wherever possible. Collective."""
    return Mesh(order_devices_slice_major(devices), (axis_name,), device)


def make_mesh_2d(shape: tuple[int, int], devices=None,
                 axis_names=("x", "y"), device=None) -> Mesh:
    """(pz, py) mesh, host-major rank order (the same seam policy: the
    slower-varying axis crosses hosts). Collective."""
    ranks = order_devices_slice_major(devices)
    n = shape[0] * shape[1]
    grid = np.empty(n, object)
    grid[:] = ranks[:n]
    return Mesh(grid.reshape(shape), axis_names, device)


# -- halo exchanges -----------------------------------------------------------


def exchange_halos(arrs, mesh: Mesh, axis_name: str | None = None):
    """exchange_halo of several [P, ...] slabs of one shape, in one
    message each way."""
    last = torch.stack([a[-1] for a in arrs])    # → forward rank's left halo
    first = torch.stack([a[0] for a in arrs])
    left, right = mesh.ring_exchange(mesh.axis(axis_name), last, first)
    return [torch.cat([lo[None], a, hi[None]])
            for a, lo, hi in zip(arrs, left, right)]


def exchange_halo(arr: torch.Tensor, mesh: Mesh,
                  axis_name: str | None = None) -> torch.Tensor:
    """[P, ...] local slab → [P+2, ...] with the neighbours' halo planes
    (wrapping ring: the unsharded engine's dim-0 roll wraparound)."""
    return exchange_halos([arr], mesh, axis_name)[0]


def exchange_row_halos(arrs, fills, X: int, mesh: Mesh, axis_name: str):
    """exchange_row_halo of several [P, K, C_local] slabs, in one message
    each way; `fills` gives each slab's sentinel row value."""
    last = torch.stack([a[:, :, -X:] for a in arrs])
    first = torch.stack([a[:, :, :X] for a in arrs])
    left, right = mesh.ring_exchange(mesh.axis(axis_name), last, first)
    out = []
    for a, lo, hi, fill in zip(arrs, left, right, fills):
        sent = torch.full(a.shape[:2] + (7 * X,), fill, dtype=a.dtype,
                          device=a.device)
        out.append(torch.cat([sent, lo, a, hi, sent], dim=2))
    return out


def exchange_row_halo(arr: torch.Tensor, X: int, mesh: Mesh, axis_name: str,
                      sent_fill: float) -> torch.Tensor:
    """[P, K, C_local] → [P, K, C_local + 16·X]: ±1 real halo row from the
    y-neighbours, wrapped in 7 sentinel rows per side (the alignment filler
    of the JAX layout: the padded fused axis stays a multiple of 128)."""
    return exchange_row_halos([arr], [sent_fill], X, mesh, axis_name)[0]


def _pad_fill(params: SPHParams) -> dict[str, float]:
    """Per-field fill value for inert (sentinel/empty) planes."""
    return dict(px=dense.SENTINEL, py=dense.SENTINEL, pz=dense.SENTINEL,
                vx=0.0, vy=0.0, vz=0.0, occ=0.0,
                rho=params.rest_density, prs=0.0, pr2=0.0)


# -- the sharded fluid step ---------------------------------------------------


def blocks(spec: DenseSpec, shape: tuple[int, ...]) -> tuple[int, int]:
    """(planes, rows) of one rank's block on a mesh of `shape`: n0 over the
    first axis, rounded up; over a 2D mesh n1 over the second in whole
    multiples of 8 rows (so every local fused axis (rows + 16)·X stays a
    multiple of 128), over a ring all n1 rows."""
    planes = -(-spec.n0 // shape[0])
    if len(shape) == 1:
        return planes, spec.n1
    return planes, -(-spec.n1 // (8 * shape[1])) * 8


def local_spec(spec: DenseSpec, shape: tuple[int, ...]) -> DenseSpec:
    """The spec the sweeps see on a rank's padded block: the global one
    over a ring; over a 2D mesh its local rows plus 2·8 rows of halo and
    sentinel filler."""
    if len(shape) == 1:
        return spec
    if not (spec.ndim == 3 and spec.stencil0 and spec.stencil1):
        raise ValueError("2D decomposition needs a 3D spec with both "
                         "stencils")
    return dataclasses.replace(spec, n1=blocks(spec, shape)[1] + 16)


def contact_rows(spec, shape: tuple[int, ...]) -> int | None:
    """Rows of one rank's block of the colony layout over a 2D mesh (whole
    multiples of 8, so local Y + 8 keeps Y % 8 == 0); None over a ring."""
    if len(shape) == 1:
        return None
    return -(-spec.ny // (8 * shape[1])) * 8


class _Slab:
    """How one rank pads and cuts its block of the fluid: the halo pad
    (rows first, then planes), the interior cut, and the global index of
    the padded block's first plane and row (the rebin's offsets)."""

    def __init__(self, params: SPHParams, spec: DenseSpec, mesh: Mesh,
                 planes: int, rows: int):
        self.mesh = mesh
        self.X = spec.X
        self.fills = _pad_fill(params)
        self.sweep_spec = local_spec(spec, mesh.shape)
        self.dim0_offset = mesh.coords[0] * planes - 1
        self.dim1_offset = mesh.coords[1] * rows - 8 if mesh.ndim == 2 else 0

    def pad(self, fields: dict) -> dict:
        names, arrs = list(fields), list(fields.values())
        m = self.mesh
        if m.ndim == 2:
            arrs = exchange_row_halos(arrs, [self.fills[f] for f in names],
                                      self.X, m, m.axis_names[1])
        return dict(zip(names, exchange_halos(arrs, m, m.axis_names[0])))

    def interior(self, a: torch.Tensor) -> torch.Tensor:
        if self.mesh.ndim == 2:
            return a[1:-1, :, 8 * self.X:-8 * self.X]
        return a[1:-1]


def _local_step(d: DenseFluidState, params: SPHParams, spec: DenseSpec,
                slab: _Slab, rebin_now: bool) -> DenseFluidState:
    """One step on a rank's block with the halo exchanges where neighbour
    data is needed; every padded tensor's interior is its block."""
    # Density needs only the neighbours' positions and occupancy.
    pos = slab.pad(dict(px=d.px, py=d.py, pz=d.pz, occ=d.occ))
    f = dense.step_passes(params)
    raw = f.density(pos["px"], pos["py"], pos["pz"], pos["occ"], params,
                    slab.sweep_spec)
    rho_p, prs_p, pr2_p = f.tail(raw, pos["occ"], params)

    # Forces also need the neighbours' velocities, ρ and p/ρ²: the halo's
    # come from their owners (the halo planes computed here saw positions
    # only beyond the block's edge). p/ρ² is elementwise in (ρ, p), so the
    # owner's equals what this block would form from their ρ and p (dp
    # keeps the block's own unpadded p, which no pass reads).
    rho_own, prs_own = slab.interior(rho_p), slab.interior(prs_p)
    rest = slab.pad(dict(vx=d.vx, vy=d.vy, vz=d.vz, rho=rho_own,
                         pr2=slab.interior(pr2_p)))
    pr2 = rest.pop("pr2")
    dp = d.replace_fields(**pos, **rest)
    ax, ay, az = f.accel(dp, pr2, params, slab.sweep_spec)
    *moved, n_clamped, n_pushed = f.integrate(
        dp, ax, ay, az, params, dense.rebin_vmax(params, spec))
    moved = dict(zip(MOVED, (slab.interior(a) for a in moved)))
    d = d.replace_fields(rho=rho_own, prs=prs_own)
    drops = torch.zeros_like(d.dropped)
    if rebin_now:
        # Rebin the padded block: emigrants into halo planes land in the
        # neighbour's interior through its copy of this block's edge, with
        # their owner's ρ and p.
        pad = slab.pad(dict(**moved, occ=d.occ, rho=d.rho, prs=d.prs))
        out = dense.rebin(d.replace_fields(occ=pad["occ"], rho=pad["rho"],
                                           prs=pad["prs"]),
                          *(pad[f] for f in MOVED), params, spec,
                          dim0_offset=slab.dim0_offset,
                          dim1_offset=slab.dim1_offset)
        drops = out.dropped - d.dropped
        d = d.replace_fields(**{f: slab.interior(getattr(out, f))
                                for f in (*MOVED, "occ", "rho", "prs")})
    else:
        d = d.replace_fields(**moved)
    # Alarm counters, summed over the mesh: clamps (and the obstacles'
    # pushed lanes) are counted on the padded block and drops on both
    # owners of an edge cell, so edge cells may count twice, as in the JAX
    # package. Each rank adds the mesh's push count to its device's total.
    counts = slab.mesh.all_reduce(torch.stack([n_clamped, drops,
                                               n_pushed]))
    obstacle_pushed(d.px.device).add_(counts[2])
    return d.replace_fields(step_count=d.step_count + 1,
                            clamped=d.clamped + counts[0],
                            dropped=d.dropped + counts[1])


def _make_step(params: SPHParams, spec: DenseSpec, mesh: Mesh,
               substeps: int):
    dense._check_rebin_cadence(params, spec)
    slab = _Slab(params, spec, mesh, *blocks(spec, mesh.shape))

    def f(d: DenseFluidState, step: int, drag=None) -> DenseFluidState:
        if drag is not None:
            raise NotImplementedError("interactive drag is single-device "
                                      "for now")
        for i in range(substeps):
            d = _local_step(d, params, spec, slab,
                            dense.is_rebin_step(step + i, params))
        return d

    return f


def make_sharded_dense_step(params: SPHParams, spec: DenseSpec, mesh: Mesh,
                            substeps: int = 1):
    """(block, step, drag=None) -> block after `substeps` steps on a 1D
    ring: this rank's block of planes (`shard_dense_state`) stepped with
    halo exchanges. `step` is the host's mirror of the step count, as for
    dense.make_dense_step, whose result this equals bitwise."""
    if mesh.ndim != 1:
        raise ValueError("make_sharded_dense_step takes a 1D mesh; use "
                         "make_sharded_dense_step_2d")
    return _make_step(params, spec, mesh, substeps)


def make_sharded_dense_step_2d(params: SPHParams, spec: DenseSpec,
                               mesh: Mesh, substeps: int = 1):
    """The step over a (pz, py) mesh: layout dim 0 (world x planes) over
    mesh axis 0, layout dim 1 (world y rows, inside the fused axis) over
    mesh axis 1; row halos ride the fused axis inside a 7-sentinel-row pad
    per side, and the sweeps run on `local_spec`."""
    if mesh.ndim != 2:
        raise ValueError("make_sharded_dense_step_2d takes a 2D mesh")
    local_spec(spec, mesh.shape)
    return _make_step(params, spec, mesh, substeps)


def make_sharded_step(params: SPHParams, spec: DenseSpec, mesh: Mesh,
                      substeps: int = 1):
    """The 1D or 2D sharded step, by the mesh's rank."""
    if mesh.ndim == 1:
        return make_sharded_dense_step(params, spec, mesh, substeps)
    return make_sharded_dense_step_2d(params, spec, mesh, substeps)


def _framed(x: torch.Tensor, fill: float, dim: int, n: int):
    """x with n `fill` entries added at both ends of `dim`."""
    ext = list(x.shape)
    ext[dim] = n
    side = torch.full(ext, fill, dtype=x.dtype, device=x.device)
    return torch.cat([side, x, side], dim=dim)


def _padded_to(x: torch.Tensor, fill: float, dim: int, n: int):
    """x extended along `dim` to length n with `fill`."""
    ext = list(x.shape)
    ext[dim] = n - x.shape[dim]
    if ext[dim] == 0:
        return x
    return torch.cat([x, torch.full(ext, fill, dtype=x.dtype,
                                    device=x.device)], dim=dim)


def cut_block(x: torch.Tensor, fill: float, size: tuple[int, int],
              shape: tuple[int, ...], coords: tuple[int, ...],
              row_dim: int = 1, halo: bool = False,
              sentinels: int = 0) -> torch.Tensor:
    """Rank `coords`' block of the global array `x` on a mesh of `shape`,
    with no exchange: dim 0 in blocks of size[0] planes and, over a 2D
    mesh, dim `row_dim` in blocks of size[1] rows, `x` first padded with
    `fill` to whole blocks. With `halo`, the block's planes ±1 and rows ±1
    as a wrapping ring of ranks delivers them, the row halo inside
    `sentinels` fill rows a side (rows are cut first, so the halo planes
    carry the padded rows, as the 2D exchanges' corners do)."""
    h = int(halo)
    cuts = [(0, size[0])] + ([(row_dim, size[1])] if len(shape) == 2 else [])
    for axis in reversed(range(len(cuts))):
        dim, n = cuts[axis]
        total = n * shape[axis]
        x = _padded_to(x, fill, dim, total)
        start = coords[axis] * n - h
        idx = torch.arange(start, start + n + 2 * h, device=x.device) % total
        x = x.index_select(dim, idx)
        if axis == 1 and halo and sentinels:
            x = _framed(x, fill, dim, sentinels)
    return x.contiguous()


def fluid_block(x: torch.Tensor, fill: float, spec: DenseSpec,
                shape: tuple[int, ...], coords: tuple[int, ...],
                halo: bool = False) -> torch.Tensor:
    """Rank `coords`' block of a global fluid field [n0, K, C] on a mesh of
    `shape` (`cut_block` over planes and, in 2D, rows of X lanes of the
    fused axis); with `halo`, the padded block the sweeps see: planes ±1,
    and in 2D rows ±1 inside 7 sentinel rows a side."""
    n0, K = x.shape[:2]
    out = cut_block(x.reshape(n0, K, -1, spec.X), fill,
                    blocks(spec, shape), shape, coords, row_dim=2,
                    halo=halo, sentinels=7)
    return out.view(out.shape[0], K, -1)


def fluid_slab(d: DenseFluidState, params: SPHParams, spec: DenseSpec,
               shape: tuple[int, ...], coords: tuple[int, ...]):
    """The halo-padded block of every field that rank `coords` of a mesh
    of `shape` sweeps in a sharded step, cut from the global state `d` as
    the ring's exchanges deliver it. Returns (block, the spec its sweeps
    take) — for checking and timing the kernels at the sharded shapes
    without a world of ranks."""
    fills = _pad_fill(params)
    return (d.replace_fields(**{
        f: fluid_block(getattr(d, f), fills[f], spec, shape, coords, True)
        for f in FIELDS}), local_spec(spec, shape))


def shard_dense_state(d: DenseFluidState, mesh: Mesh, spec: DenseSpec,
                      params: SPHParams) -> DenseFluidState:
    """This rank's block of a global state (every rank passes the same
    one), on the mesh's device. An uneven n0 (and n1 in 2D) is padded
    first with inert sentinel planes (rows) past the top margin, where no
    roll and no rebin target reaches."""
    fills = _pad_fill(params)
    out = {f: fluid_block(getattr(d, f), fills[f], spec, mesh.shape,
                          mesh.coords).to(mesh.device)
           for f in FIELDS}
    counters = {f: getattr(d, f).to(mesh.device).clone()
                for f in ("dropped", "clamped", "step_count")}
    return DenseFluidState(**out, **counters)


def unshard_dense_state(d: DenseFluidState, mesh: Mesh,
                        spec: DenseSpec) -> DenseFluidState:
    """The global state from every rank's block (all_gather: every rank
    gets it), cut back to [spec.n0, K, spec.C]. Collective."""
    full = mesh.all_gather_blocks(
        torch.stack([getattr(d, f) for f in FIELDS]), dims=(1, 3))
    full = full[:, :spec.n0, :, :spec.C]
    return d.replace_fields(**{f: full[i].clone()
                               for i, f in enumerate(FIELDS)})


# -- the sharded contact forces -----------------------------------------------


def _contact_spec(params, spec):
    from sph_tpu_torch.physics.contact_dense import make_contact_spec

    if spec is None:
        spec = make_contact_spec(params, k=params.dense_k,
                                 cell_factor=params.dense_cell_factor)
    return spec


def contact_block(planes_in, spec, shape: tuple[int, ...],
                  coords: tuple[int, ...]):
    """Rank `coords`' halo-padded block of the colony's packed planes (the
    10 fields, then the occupancy plane if given) on a mesh of `shape`,
    cut from the whole pack, which every rank holds: its z planes ±1 and,
    over a 2D mesh, its rows ±1 inside 3 sentinel rows a side (local Y + 8
    keeps the row-block contract Y % 8 == 0). Returns (padded planes, the
    spec of the block, which its sweep takes)."""
    from sph_tpu_torch.physics.contact_dense import PACK_FILLS

    planes = -(-spec.nz // shape[0])
    rows = contact_rows(spec, shape)
    block = [cut_block(x, fill, (planes, rows), shape, coords, row_dim=1,
                       halo=True, sentinels=3)
             for x, fill in zip(planes_in, PACK_FILLS)]
    ny = spec.ny if rows is None else rows + 8
    return block, dataclasses.replace(spec, nz=planes + 2, ny=ny)


def _contact_forces(params, mesh: Mesh, spec):
    """The sharded contact forces: the pack (the slots kernel and K5 on
    the card) replicated on every rank; the rank's halo-padded block, cut
    from it, through the sweep (K4 on the card); the six components
    gathered over the mesh, then one row gather back to particle order
    (the gather kernel on the card)."""
    from sph_tpu_torch.physics import contact_dense as cd

    rows = contact_rows(spec, mesh.shape)
    use_kernel = params.use_pallas

    def pair(*a):
        return cd.contact_pair_terms(params, *a)

    def f(state):
        fields, occ, slot_of, overflow = cd._pack_args(
            state, spec, expand=use_kernel)
        # The plain sweep reads no occupancy: only the kernel's is cut.
        padded, sweep_spec = contact_block(
            [*fields, occ] if use_kernel else list(fields), spec,
            mesh.shape, mesh.coords)
        if use_kernel:
            from sph_tpu_torch.ops.contact import contact_sweep

            comps = contact_sweep(padded[:10], padded[10], params,
                                  sweep_spec)
        else:
            comps = cd._sweep_plain(padded, pair, 6, sweep_spec)
        own = torch.stack([c[1:-1] if rows is None
                           else c[1:-1, 4:4 + rows] for c in comps])
        full = mesh.all_gather_blocks(own, dims=(1, 2))
        full = full[:, :spec.nz, :spec.ny]
        return cd._gather_back(full, slot_of, overflow, kernel=use_kernel)

    return f


def make_sharded_contact_forces(params, mesh: Mesh, spec=None):
    """state -> (force, torque, overflow) with the colony's contact sweep
    decomposed over a 1D ring: z-plane slabs of the [Z, Y, X·K] layout with
    one-plane halos, the ring the fluid uses. The pack stays replicated
    (at colony scale the sweep dominates, and division and bond tables are
    replicated anyway), so the halos are cut from it, not exchanged. Bitwise equal to the single-device sweep: interior
    planes see identical 3-plane inputs, and the single-device wrap and the
    wrapping ring both resolve global-edge planes to sentinel data whose
    pair terms are exact zeros."""
    if mesh.ndim != 1:
        raise ValueError("make_sharded_contact_forces takes a 1D mesh")
    return _contact_forces(params, mesh, _contact_spec(params, spec))


def make_sharded_contact_forces_2d(params, mesh: Mesh, spec=None):
    """The contact sweep over a (pz, py) mesh of z-slabs × y-blocks: ±1
    halo rows in a 3-sentinel-row pad and ±1 halo planes, cut from the
    replicated pack. Bitwise equal to the single-device sweep by the 1D
    argument."""
    if mesh.ndim != 2:
        raise ValueError("make_sharded_contact_forces_2d takes a 2D mesh")
    return _contact_forces(params, mesh, _contact_spec(params, spec))
