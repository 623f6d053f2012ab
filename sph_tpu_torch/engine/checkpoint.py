"""Checkpoint / resume of a colony — the counterpart of
sph_tpu.engine.checkpoint, in its format: one npz of the flat state
(`state_to_numpy` keys, dtypes kept: f32 fields, int32 ids and counters,
bool flags, the PRNG key's two uint32 words) plus a JSON header (format
version, params, genome modes, Simulation settings). A file written by
either package loads in the other."""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from sph_tpu_torch.core.types import (
    Genome,
    GenomeMode,
    SimParams,
    SimState,
    state_from_numpy,
    state_to_numpy,
)

_FORMAT_VERSION = 1


def save_checkpoint(path: str, state: SimState, params: SimParams,
                    genome: Genome, sim_meta: dict | None = None) -> None:
    """sim_meta: the Simulation settings worth restoring (seed, rng_mode):
    without them a later resize() of the loaded sim would initialise grown
    rows from another stream than the original run."""
    header = {
        "version": _FORMAT_VERSION,
        "params": dataclasses.asdict(params),
        "genome": [dataclasses.asdict(m) for m in genome.modes],
        "sim": sim_meta or {},
    }
    np.savez_compressed(path, __header__=json.dumps(header),
                        **state_to_numpy(state))


def load_checkpoint(path: str, device="cuda"):
    """(state on `device`, params, genome, sim settings) of a checkpoint."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k != "__header__"}
        header = json.loads(str(data["__header__"]))
    if header["version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {header['version']}")
    params = SimParams(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in header["params"].items()
    })
    modes = []
    for m in header["genome"]:
        m = dict(m)
        m["mode_color"] = tuple(m["mode_color"])
        modes.append(GenomeMode(**m))
    return (state_from_numpy(flat, device), params, Genome(tuple(modes)),
            header.get("sim", {}))
