"""Seeded inputs of config[3], the 3D dam break past an SDF pillar: the
water column on its lattice, as sph_tpu_torch/sph/scenes.py
`dam_break_3d` lays it (spacing dx = cbrt(column volume ÷ n_target), points
at dx/2 + i·dx), each coordinate then moved by a uniform jitter of
± `jitter`·dx drawn from --seed by one torch.Generator on the run's
device, and the constants that `_fluid_params` derives from dx: h = 1.3 dx,
particle mass ρ0·dx³, dt = cfl·h ÷ c. A frozen copy, so that a change of
the program's scene builder cannot move the benchmark's inputs."""

from __future__ import annotations

import numpy as np
import torch


def physics(cfg) -> dict:
    """The run's physical constants: the configuration's own values and
    those derived from the lattice spacing."""
    ph = cfg["physics"]
    col = cfg["column"]
    dx = float(np.cbrt(col[0] * col[1] * col[2] / cfg["n_target"]))
    h = ph["h_over_dx"] * dx
    return {**{k: v for k, v in ph.items()
               if k not in ("h_over_dx", "cfl")},
            "dx": dx, "h": h, "particle_mass": ph["rest_density"] * dx ** 3,
            "dt": ph["cfl"] * h / ph["sound_speed"],
            "bounds_min": (0.0, 0.0, 0.0), "bounds_max": tuple(cfg["tank"]),
            "obstacles": tuple((o[0], tuple(o[1]), o[2])
                               for o in cfg["obstacles"])}


def build(cfg, seed: int, device) -> dict:
    """{"pos": [N, 3] f32 on `device`, **physics(cfg)}."""
    ph = physics(cfg)
    dx = ph["dx"]
    axes = [torch.from_numpy(np.arange(dx * 0.5, hi, dx)).to(device)
            for hi in cfg["column"]]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(pts.shape, generator=gen, dtype=torch.float64,
                   device=device)
    pos = (pts + (2.0 * u - 1.0) * (cfg["jitter"] * dx)).float()
    return {"pos": pos.contiguous(), **ph}
