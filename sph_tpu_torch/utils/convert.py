"""Carrying state across from the JAX package: its SPHParams (as the dict
`dataclasses.asdict` gives, or a checkpoint header's JSON of it) and the
fields of its DenseFluidState (as numpy arrays)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sph_tpu_torch.sph.dense import DenseFluidState
from sph_tpu_torch.sph.model import SPHParams

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


def state_from_numpy(arrays: dict, device="cpu") -> DenseFluidState:
    """DenseFluidState on `device` from numpy arrays of every field: f32
    [Z, K, C] component arrays and int32 scalar counters (copied, so the
    state never aliases the caller's buffers)."""
    out = {}
    for f in dataclasses.fields(DenseFluidState):
        a = np.array(arrays[f.name], copy=True)
        dtype = torch.int32 if f.name in _COUNTERS else torch.float32
        out[f.name] = torch.from_numpy(a).to(device=device, dtype=dtype)
    return DenseFluidState(**out)
