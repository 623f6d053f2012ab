"""Carrying state across from the JAX package: its SPHParams (as the dict
`dataclasses.asdict` gives, or a checkpoint header's JSON of it), the
fields of its DenseFluidState and of its flat SPHState (config[0]'s grid
path) as numpy arrays; for the colony its SimParams, its genome JSON, its
SimState (the `state_to_numpy` dict) and an adhesion BondPlan."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sph_tpu_torch.core.types import Genome, SimParams, SimState
from sph_tpu_torch.core.types import state_from_numpy as sim_state_from_numpy
from sph_tpu_torch.engine.config import genome_from_json
from sph_tpu_torch.physics.adhesion import BondPlan
from sph_tpu_torch.sph.dense import DenseFluidState
from sph_tpu_torch.sph.model import SPHParams, SPHState

_COUNTERS = ("dropped", "clamped", "step_count")


def _tuples(v):
    """JSON turns tuples into lists, at every depth (obstacle specs nest);
    SPHParams is hashable and compares with tuples, so turn them back."""
    if isinstance(v, (list, tuple)):
        return tuple(_tuples(x) for x in v)
    return v


def params_from_jax(p: dict) -> SPHParams:
    """SPHParams from `dataclasses.asdict` of a JAX SPHParams."""
    names = {f.name for f in dataclasses.fields(SPHParams)}
    unknown = set(p) - names
    if unknown:
        raise ValueError(f"unknown SPHParams fields: {sorted(unknown)}")
    return SPHParams(**{k: _tuples(v) for k, v in p.items()})


def state_from_numpy(arrays: dict, device="cuda") -> DenseFluidState:
    """DenseFluidState on `device` from numpy arrays of every field: f32
    [Z, K, C] component arrays and int32 scalar counters (copied, so the
    state never aliases the caller's buffers)."""
    out = {}
    for f in dataclasses.fields(DenseFluidState):
        a = np.array(arrays[f.name], copy=True)
        dtype = torch.int32 if f.name in _COUNTERS else torch.float32
        out[f.name] = torch.from_numpy(a).to(device=device, dtype=dtype)
    return DenseFluidState(**out)


def sph_state_from_numpy(arrays: dict, device="cuda") -> SPHState:
    """The flat SPHState on `device` from numpy arrays of every field: f32
    pos/vel [N, 3] and density/pressure [N], int32 scalar counters
    (copied, so the state never aliases the caller's buffers)."""
    out = {}
    for f in dataclasses.fields(SPHState):
        a = np.array(arrays[f.name], copy=True)
        dtype = (torch.int32 if f.name in ("step_count", "bin_overflow")
                 else torch.float32)
        out[f.name] = torch.from_numpy(a).to(device=device, dtype=dtype)
    return SPHState(**out)


# -- the colony -------------------------------------------------------------


def sim_params_from_jax(p: dict) -> SimParams:
    """SimParams from `dataclasses.asdict` of a JAX SimParams (or the
    "params" object of its scene JSON)."""
    names = {f.name for f in dataclasses.fields(SimParams)}
    unknown = set(p) - names
    if unknown:
        raise ValueError(f"unknown SimParams fields: {sorted(unknown)}")
    return SimParams(**p)


def colony_from_jax(flat: dict, params: dict, genome_json: str,
                    device="cuda") -> tuple[SimState, SimParams, Genome]:
    """A JAX colony carried across: the flat `state_to_numpy` dict (copied
    bitwise, dtypes kept: f32 fields, int32 ids/slots/counters, the PRNG
    key's two uint32 words), its params dict and its genome JSON."""
    return (sim_state_from_numpy(flat, device), sim_params_from_jax(params),
            genome_from_json(genome_json))


def bond_plan_from_numpy(arrays: dict, device="cuda") -> BondPlan:
    """A BondPlan on `device` from numpy arrays of every field of a JAX
    BondPlan (`{f: np.asarray(getattr(plan, f))}`): perm and last as int64
    indices (JAX keeps them as int32), the rest with their dtypes."""
    out = {}
    for f in dataclasses.fields(BondPlan):
        t = torch.from_numpy(np.array(arrays[f.name], copy=True))
        if f.name in ("perm", "last"):
            t = t.long()
        out[f.name] = t.to(device)
    return BondPlan(**out)
