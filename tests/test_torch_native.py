"""Port vs the C++ golden oracle (sph_tpu/native/golden.py): the colony's
per-particle passes of sph_tpu_torch.physics — contact forces and torques,
the motion pass, the rotation pass — against the oracle's, on the same
numpy state, at the tolerances the JAX package holds itself to against the
oracle (tests/test_native_golden.py).

This module also builds the oracle's shared library while it is imported,
once per test session. The reason is a fault in the reference: `_lib()`
takes the non-reentrant `threading.Lock` `_LOCK` (golden.py:67) and, inside
it, calls `ensure_built()` (:69), which takes `_LOCK` again (:36) whenever
the library file does not exist yet. So the first caller of `_lib()` on a
fresh checkout deadlocks for good, and a test run stalls until its clock
cuts it (tests/test_native_topology.py reaches `_lib()` that way). Every
pytest-xdist worker imports every test file before it runs any test, so
building here, before any test runs, means `_lib()` always finds the
library. An exclusive `fcntl.flock` on a lock file under the ignored
`build/` directory keeps two workers from writing the same `.so.tmp`. The
repair belongs in golden.py — call `ensure_built()` before taking `_LOCK`
in `_lib()`, or make `_LOCK` a `threading.RLock` — and is left for a change
that may edit the JAX package (ROADMAP §C)."""

import fcntl
from pathlib import Path

import numpy as np
import torch

from sph_tpu.native import golden
from sph_tpu_torch.core import quat
from sph_tpu_torch.core.types import SimParams, SimState
from sph_tpu_torch.physics.contact import contact_forces_bruteforce
from sph_tpu_torch.physics.integrate import update_motion, update_rotation

torch.set_num_threads(1)


def _build_oracle_once() -> str:
    lock = Path(__file__).resolve().parents[1] / "build" / "golden.lock"
    lock.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            return golden.ensure_built()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


ORACLE = _build_oracle_once()

# tests/test_native_golden.py's parameters.
PARAMS = SimParams(dt=0.02, repulsion_strength=200.0, torque_factor=1.3,
                   rolling_contact_radius_multiplier=5.0, spawn_radius=8.0,
                   boundary_friction=0.8, torque_damping=0.5,
                   global_drag_multiplier=3.0)


def random_state(n=48, seed=0, spread=6.0) -> SimState:
    """n cells (n − 4 live) drawn with numpy: overlapping spheres with
    random velocities, spins and orientations."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32))

    return SimState.zeros(n, PARAMS, device="cpu").replace_fields(
        pos=f32(rng.uniform(-spread, spread, (n, 3))),
        vel=f32(rng.normal(size=(n, 3))),
        ang_vel=f32(rng.normal(size=(n, 3)) * 0.5),
        radius=f32(rng.uniform(1.5, 2.5, n)),
        rot=quat.normalize(f32(rng.normal(size=(n, 4)))),
        mass=f32(rng.uniform(0.5, 2.0, n)),
        inertia=torch.full((n,), 1.3),
        drag=torch.full((n,), 0.7),
        torque_accum=f32(rng.normal(size=(n, 3)) * 0.1),
        active_count=torch.tensor(n - 4, dtype=torch.int32),
    )


def test_oracle_built_at_import():
    assert ORACLE.endswith(".so") and Path(ORACLE).is_file()


def test_contact_forces_match_oracle():
    st = random_state()
    f_t, t_t = contact_forces_bruteforce(st, PARAMS)
    f_c, t_c, accum_c = golden.contact_forces_native(st, PARAMS)
    assert np.abs(f_c).max() > 0            # the spheres do touch
    scale = max(float(f_t.abs().max()), 1e-6)
    assert np.abs(f_t.numpy() - f_c).max() / scale < 2e-5
    t_scale = max(float(t_t.abs().max()), 1e-6)
    assert np.abs(t_t.numpy() - t_c).max() / t_scale < 2e-5
    np.testing.assert_allclose(accum_c, t_t.numpy() * PARAMS.dt,
                               atol=t_scale * 2e-5)


def test_update_motion_matches_oracle():
    st = random_state(seed=3)
    out = update_motion(st, PARAMS)
    pos_c, vel_c, ang_c = golden.update_motion_native(st, PARAMS)
    n = int(st.active_count)
    np.testing.assert_allclose(out.pos.numpy()[:n], pos_c[:n], atol=1e-4)
    np.testing.assert_allclose(out.vel.numpy()[:n], vel_c[:n], atol=1e-4)
    np.testing.assert_allclose(out.ang_vel.numpy()[:n], ang_c[:n],
                               atol=1e-3)


def test_update_rotation_matches_oracle():
    st = random_state(seed=4)
    out = update_rotation(st, PARAMS)
    ang_c, rot_c = golden.update_rotation_native(st, PARAMS)
    n = int(st.active_count)
    np.testing.assert_allclose(out.ang_vel.numpy()[:n], ang_c[:n],
                               atol=1e-5)
    np.testing.assert_allclose(out.rot.numpy()[:n], rot_c[:n], atol=1e-5)
