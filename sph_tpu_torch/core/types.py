"""Core datatypes — the counterpart of sph_tpu.core.types: static config
(SimParams, Genome) and the device state as dataclasses of tensors.

Config mirrors the reference's config tiers (SURVEY §5.6): inspector fields
→ `SimParams`, the genome ScriptableObject → `Genome`/`GenomeMode`
(CellGenome.cs:124-170). State is a fixed-capacity SoA with an
`active_count` mask (SimulateParticles.compute:121). Dtypes are the JAX
package's: f32 fields, int32 ids, slots and counters, bool flags, and the
PRNG key as its two uint32 words, so state converts and checkpoints
bitwise between the packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields
from typing import Any

import numpy as np
import torch


def state_dataclass(cls):
    """A dataclass of tensors with `replace_fields` (dataclasses.replace)."""
    cls = dataclass(cls)
    cls.replace_fields = dataclasses.replace
    return cls


# ---------------------------------------------------------------------------
# Genome (static config; CellGenome.cs:124-170 field for field)
# ---------------------------------------------------------------------------

_RANGES = {
    "split_interval": (1.0, 15.0),
    "parent_split_yaw": (-180.0, 180.0),
    "parent_split_pitch": (-90.0, 90.0),
    "child_a_orientation_yaw": (-180.0, 180.0),
    "child_a_orientation_pitch": (-90.0, 90.0),
    "child_b_orientation_yaw": (-180.0, 180.0),
    "child_b_orientation_pitch": (-90.0, 90.0),
    "adhesion_rest_length": (1.0, 10.0),
    "adhesion_spring_stiffness": (10.0, 500.0),
    "adhesion_spring_damping": (0.0, 100.0),
    "orientation_constraint_strength": (0.0, 1.0),
    "max_allowed_angle_deviation": (0.0, 180.0),
    "adhesion_break_force": (100.0, 5000.0),
}


@dataclass(frozen=True)
class GenomeMode:
    """One genome mode (CellGenome.cs:124-170)."""

    mode_name: str = ""
    split_interval: float = 5.0
    is_initial: bool = False
    parent_make_adhesion: bool = False
    mode_color: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    parent_split_yaw: float = 0.0
    parent_split_pitch: float = 0.0
    child_a_mode_index: int = -1  # -1 ⇒ inherit parent mode
    child_a_orientation_yaw: float = 0.0
    child_a_orientation_pitch: float = 0.0
    child_a_keep_adhesion: bool = False
    child_b_mode_index: int = -1
    child_b_orientation_yaw: float = 0.0
    child_b_orientation_pitch: float = 0.0
    child_b_keep_adhesion: bool = False
    adhesion_rest_length: float = 3.0
    adhesion_spring_stiffness: float = 100.0
    adhesion_spring_damping: float = 5.0
    orientation_constraint_strength: float = 0.5
    # Declared but read by no reference kernel (CellGenome.cs:164-169);
    # carried for config parity.
    max_allowed_angle_deviation: float = 45.0
    adhesion_can_break: bool = False
    adhesion_break_force: float = 1000.0

    def validate(self) -> None:
        for name, (lo, hi) in _RANGES.items():
            v = getattr(self, name)
            if not (lo <= v <= hi):
                raise ValueError(f"GenomeMode.{name}={v} outside [{lo}, {hi}]")


@dataclass(frozen=True)
class Genome:
    """A validated list of modes; at most one is initial
    (CellGenome.cs:73-89)."""

    modes: tuple[GenomeMode, ...] = ()

    def validate_for_simulation(self) -> "Genome":
        """Enforce a single initial mode (ValidateForSimulation)."""
        initial = [i for i, m in enumerate(self.modes) if m.is_initial]
        if len(initial) > 1:
            names = ", ".join(self.modes[i].mode_name or f"Mode {i}"
                              for i in initial)
            raise ValueError(f"Multiple initial modes detected: {names}")
        for m in self.modes:
            m.validate()
        if not initial and self.modes:
            modes = list(self.modes)
            modes[0] = dataclasses.replace(modes[0], is_initial=True)
            return Genome(tuple(modes))
        return self

    @property
    def initial_mode_index(self) -> int:
        for i, m in enumerate(self.modes):
            if m.is_initial:
                return i
        return 0

    def to_device(self, device="cuda") -> "GenomeDevice":
        """Per-mode scalars stacked into tensors on `device`. A zero-mode
        genome gets one dummy row so lookups never index an empty tensor;
        n_modes = 0 already marks every particle's mode invalid."""
        modes = self.modes if self.modes else (GenomeMode(),)

        def col(name, dtype=torch.float32):
            return torch.tensor([getattr(m, name) for m in modes],
                                dtype=dtype, device=device)

        return GenomeDevice(
            n_modes=torch.tensor(len(self.modes), dtype=torch.int32,
                                 device=device),
            split_interval=col("split_interval"),
            parent_make_adhesion=col("parent_make_adhesion", torch.bool),
            mode_color=torch.tensor([m.mode_color for m in modes],
                                    dtype=torch.float32, device=device),
            parent_split_yaw=col("parent_split_yaw"),
            parent_split_pitch=col("parent_split_pitch"),
            child_a_mode_index=col("child_a_mode_index", torch.int32),
            child_a_orientation_yaw=col("child_a_orientation_yaw"),
            child_a_orientation_pitch=col("child_a_orientation_pitch"),
            child_a_keep_adhesion=col("child_a_keep_adhesion", torch.bool),
            child_b_mode_index=col("child_b_mode_index", torch.int32),
            child_b_orientation_yaw=col("child_b_orientation_yaw"),
            child_b_orientation_pitch=col("child_b_orientation_pitch"),
            child_b_keep_adhesion=col("child_b_keep_adhesion", torch.bool),
            adhesion_rest_length=col("adhesion_rest_length"),
            adhesion_spring_stiffness=col("adhesion_spring_stiffness"),
            adhesion_spring_damping=col("adhesion_spring_damping"),
            orientation_constraint_strength=col(
                "orientation_constraint_strength"),
            n_modes_host=len(self.modes),
        )


@state_dataclass
class GenomeDevice:
    """Genome modes as stacked tensors (one row per mode). `n_modes_host`
    is the mode count as a Python int, so host decisions need no read."""

    n_modes: torch.Tensor
    split_interval: torch.Tensor
    parent_make_adhesion: torch.Tensor
    mode_color: torch.Tensor
    parent_split_yaw: torch.Tensor
    parent_split_pitch: torch.Tensor
    child_a_mode_index: torch.Tensor
    child_a_orientation_yaw: torch.Tensor
    child_a_orientation_pitch: torch.Tensor
    child_a_keep_adhesion: torch.Tensor
    child_b_mode_index: torch.Tensor
    child_b_orientation_yaw: torch.Tensor
    child_b_orientation_pitch: torch.Tensor
    child_b_keep_adhesion: torch.Tensor
    adhesion_rest_length: torch.Tensor
    adhesion_spring_stiffness: torch.Tensor
    adhesion_spring_damping: torch.Tensor
    orientation_constraint_strength: torch.Tensor
    n_modes_host: int = 0


# ---------------------------------------------------------------------------
# SimParams (static; scene/inspector fields, Particle Simulation.unity)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimParams:
    """Static simulation parameters, field for field the JAX package's
    (so its JSON loads here unchanged). Defaults mirror the shipped scene
    (SURVEY §2.12) except capacity, which mirrors the code default."""

    dt: float = 1.0 / 60.0
    capacity: int = 4
    min_radius: float = 2.0
    max_radius: float = 2.0
    spawn_radius: float = 15.0
    global_drag_multiplier: float = 10.0
    torque_factor: float = 1.0
    torque_damping: float = 0.5
    boundary_friction: float = 0.8
    rolling_contact_radius_multiplier: float = 5.0
    density: float = 0.1
    repulsion_strength: float = 200.0
    spawn_overlap_offset: float = 0.5
    split_velocity_magnitude: float = 0.5
    enable_anchor_constraints: bool = True   # CellAdhesionManager toggle
    inheritance_angle_deg: float = 10.0      # ZoneC half-width (CAM:320)
    max_bonds: int = 4096                    # cs:129
    max_splits_per_step: int = 64
    grid_dim: int = 32
    grid_cell_size: float = 4.0
    # "bruteforce" | "grid" | "dense"
    neighbor_mode: str = "bruteforce"
    cell_capacity: int = 32
    dense_k: int = 2
    dense_cell_factor: float = 1.05
    # Dense mode: run the hand-written kernels on CUDA tensors (False = the
    # plain PyTorch versions everywhere).
    use_pallas: bool = False
    # Read by nothing; kept so the JAX package's JSON and checkpoints load.
    resident: bool = False
    contact_epsilon: float = 0.001
    slip_epsilon: float = 1e-4
    # Adhesion accumulate: "auto" = the planned accumulate for bond tables
    # of 163,840 rows or more (engine/step.use_bond_plan), "on" / "off"
    # force it. The planned sum differs from the plain one only by its
    # scan tree's reassociation.
    adhesion_plan: str = "auto"

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Device state
# ---------------------------------------------------------------------------


def _i32(v, n, device):
    return torch.full((n,), v, dtype=torch.int32, device=device)


def _scalar(v, device, dtype=torch.int32):
    return torch.full((), v, dtype=dtype, device=device)


@state_dataclass
class BondTable:
    """Fixed-capacity adhesion bond graph (CellAdhesionManager.cs:35-54).
    Bonds carry uids (identity) and slots (compute index). Zones: 0 = A,
    1 = B, 2 = C."""

    active: torch.Tensor          # [B] bool
    uid_a: torch.Tensor           # [B] i32
    uid_b: torch.Tensor           # [B] i32
    slot_a: torch.Tensor          # [B] i32
    slot_b: torch.Tensor          # [B] i32
    zone_a: torch.Tensor          # [B] i32
    zone_b: torch.Tensor          # [B] i32
    child_to_child: torch.Tensor  # [B] bool
    created_step: torch.Tensor    # [B] i32
    rel_orientation: torch.Tensor  # [B, 4] conj(qA)⊗qB at creation
    anchor_a: torch.Tensor        # [B, 3] body-frame anchor on A
    anchor_b: torch.Tensor        # [B, 3]
    anchors_set: torch.Tensor     # [B] bool

    @staticmethod
    def empty(capacity: int, device="cuda") -> "BondTable":
        B = capacity
        f32 = dict(dtype=torch.float32, device=device)
        return BondTable(
            active=torch.zeros(B, dtype=torch.bool, device=device),
            uid_a=_i32(-1, B, device), uid_b=_i32(-1, B, device),
            slot_a=_i32(-1, B, device), slot_b=_i32(-1, B, device),
            zone_a=_i32(0, B, device), zone_b=_i32(0, B, device),
            child_to_child=torch.zeros(B, dtype=torch.bool, device=device),
            created_step=_i32(-2, B, device),
            rel_orientation=_identity_rows(B, device),
            anchor_a=torch.zeros((B, 3), **f32),
            anchor_b=torch.zeros((B, 3), **f32),
            anchors_set=torch.zeros(B, dtype=torch.bool, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.active.shape[0]


def _identity_rows(n: int, device) -> torch.Tensor:
    q = torch.zeros((n, 4), dtype=torch.float32, device=device)
    q[:, 3] = 1.0
    return q


@state_dataclass
class PendingSplits:
    """Split queue: splits detected in step t apply at the start of step
    t+1 (ParticleSystemController.cs:643-646 one-frame deferral)."""

    count: torch.Tensor        # i32 scalar
    parent_slot: torch.Tensor  # [S] i32
    pos_a: torch.Tensor        # [S, 3]
    pos_b: torch.Tensor
    vel_a: torch.Tensor
    vel_b: torch.Tensor
    rot_a: torch.Tensor        # [S, 4]
    rot_b: torch.Tensor
    mode_a: torch.Tensor       # [S] i32
    mode_b: torch.Tensor
    parent_mode: torch.Tensor  # [S] i32 (adhesion keep flags, cs:936)

    @staticmethod
    def empty(capacity: int, device="cuda") -> "PendingSplits":
        S = capacity
        z3 = lambda: torch.zeros((S, 3), dtype=torch.float32,  # noqa: E731
                                 device=device)
        return PendingSplits(
            count=_scalar(0, device),
            parent_slot=_i32(-1, S, device),
            pos_a=z3(), pos_b=z3(), vel_a=z3(), vel_b=z3(),
            rot_a=_identity_rows(S, device), rot_b=_identity_rows(S, device),
            mode_a=_i32(0, S, device), mode_b=_i32(0, S, device),
            parent_mode=_i32(0, S, device),
        )


@state_dataclass
class DragInput:
    """Interactive drag state (DragInput struct, compute:70-74)."""

    selected_slot: torch.Tensor  # i32, -1 = none
    target: torch.Tensor         # [3]
    strength: torch.Tensor       # f32

    @staticmethod
    def none(device="cuda") -> "DragInput":
        return DragInput(
            selected_slot=_scalar(-1, device),
            target=torch.zeros(3, dtype=torch.float32, device=device),
            strength=_scalar(0.0, device, torch.float32),
        )


def prng_key(seed: int, device="cuda") -> torch.Tensor:
    """The two uint32 words of jax.random.PRNGKey(seed) (threefry):
    [seed >> 32, seed & 0xffffffff]."""
    words = np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                     np.uint32)
    return torch.from_numpy(words).to(device)


@state_dataclass
class SimState:
    """Full simulation state with fixed capacity N: the reference's Particle
    struct (SimulateParticles.compute:23-40) in SoA layout plus the host
    state the reference keeps in the controller (timers, ids, the uid
    counter, bonds, pending splits)."""

    pos: torch.Tensor           # [N, 3]
    vel: torch.Tensor           # [N, 3]
    ang_vel: torch.Tensor       # [N, 3]
    rot: torch.Tensor           # [N, 4] quat
    radius: torch.Tensor        # [N]
    mass: torch.Tensor          # [N]
    inertia: torch.Tensor       # [N]
    drag: torch.Tensor          # [N]
    repulsion: torch.Tensor     # [N] (uploaded but unused by the reference)
    mode: torch.Tensor          # [N] i32
    torque_accum: torch.Tensor  # [N, 3]
    split_timer: torch.Tensor   # [N]
    uid: torch.Tensor           # [N] i32
    parent_uid: torch.Tensor    # [N] i32
    child_type: torch.Tensor    # [N] i32 0 = 'A', 1 = 'B'
    active_count: torch.Tensor  # i32 scalar
    next_uid: torch.Tensor      # i32 scalar
    step_count: torch.Tensor    # i32 scalar
    overflow: torch.Tensor      # i32 scalar: dropped splits/bonds/overflows
    bonds: BondTable
    pending: PendingSplits
    drag_input: DragInput
    rng: torch.Tensor           # [2] uint32, the JAX PRNG key's words

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @staticmethod
    def zeros(capacity: int, params: SimParams, seed: int = 0,
              device="cuda") -> "SimState":
        N = capacity
        f32 = dict(dtype=torch.float32, device=device)
        return SimState(
            pos=torch.zeros((N, 3), **f32),
            vel=torch.zeros((N, 3), **f32),
            ang_vel=torch.zeros((N, 3), **f32),
            rot=_identity_rows(N, device),
            radius=torch.ones(N, **f32),
            mass=torch.ones(N, **f32),
            inertia=torch.ones(N, **f32),
            drag=torch.ones(N, **f32),
            repulsion=torch.ones(N, **f32),
            mode=_i32(0, N, device),
            torque_accum=torch.zeros((N, 3), **f32),
            split_timer=torch.zeros(N, **f32),
            uid=_i32(-1, N, device),
            parent_uid=_i32(0, N, device),
            child_type=_i32(0, N, device),
            active_count=_scalar(0, device),
            next_uid=_scalar(1, device),
            step_count=_scalar(0, device),
            overflow=_scalar(0, device),
            bonds=BondTable.empty(params.max_bonds, device),
            pending=PendingSplits.empty(params.max_splits_per_step, device),
            drag_input=DragInput.none(device),
            rng=prng_key(seed, device),
        )


_NESTED = (BondTable, PendingSplits, DragInput)


def formatted_id(parent_uid: int, uid: int, child_type: int) -> str:
    """'PP.UU.C' formatting (ParticleIDData.GetFormattedID, cs:178-191)."""
    c = "A" if child_type == 0 else "B"
    return f"{int(parent_uid):02d}.{int(uid):02d}.{c}"


def state_to_numpy(state: SimState) -> dict[str, Any]:
    """The whole state as a flat dict of numpy arrays, keyed as the JAX
    package's state_to_numpy keys it ('bonds.uid_a', ...)."""
    flat = {}

    def add(prefix: str, obj):
        for f in fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, _NESTED):
                add(prefix + f.name + ".", v)
            else:
                flat[prefix + f.name] = v.detach().cpu().numpy()

    add("", state)
    return flat


def state_from_numpy(flat: dict, device="cuda") -> SimState:
    """SimState on `device` from a flat dict of numpy arrays as
    state_to_numpy (either package's) gives it; arrays are copied, so the
    state never aliases the caller's buffers."""

    def build(cls, prefix):
        out = {}
        for f in fields(cls):
            if f.name == "n_modes_host":
                continue
            sub = {BondTable: "bonds", PendingSplits: "pending",
                   DragInput: "drag_input"}
            kind = next((c for c, n in sub.items() if n == f.name), None)
            if kind is not None and cls is SimState:
                out[f.name] = build(kind, prefix + f.name + ".")
                continue
            a = np.array(flat[prefix + f.name], copy=True)
            out[f.name] = torch.from_numpy(a).to(device)
        return cls(**out)

    return build(SimState, "")
