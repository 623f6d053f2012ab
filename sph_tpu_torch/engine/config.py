"""JSON config I/O for SimParams and Genome, and the reference scene — the
counterpart of sph_tpu.engine.config, whose JSON it reads and writes
unchanged.

`reference_genome()` is the authored NewCellGenome.asset instance
(splitInterval 5, parentMakeAdhesion on, both children keep adhesion and
stay mode 0, child yaws 90°, restLength 2.96, stiffness 200, damping 0,
orientation strength 0.493); `reference_scene_params()` the shipped scene
values (Particle Simulation.unity:150-178); `SceneWatcher`/`watch_scene`
the genome live-edit loop.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

from sph_tpu_torch.core.types import Genome, GenomeMode, SimParams


def params_to_json(params: SimParams) -> str:
    return json.dumps(dataclasses.asdict(params), indent=2)


def params_from_json(text: str) -> SimParams:
    return SimParams(**json.loads(text))


def genome_to_json(genome: Genome) -> str:
    return json.dumps(
        {"modes": [dataclasses.asdict(m) for m in genome.modes]}, indent=2
    )


def genome_from_json(text: str) -> Genome:
    data = json.loads(text)
    modes = []
    for m in data["modes"]:
        m = dict(m)
        if "mode_color" in m:
            m["mode_color"] = tuple(m["mode_color"])
        modes.append(GenomeMode(**m))
    return Genome(tuple(modes)).validate_for_simulation()


def load_scene(path: str | Path) -> tuple[SimParams, Genome]:
    """Load a {params: {...}, genome: {modes: [...]}} scene JSON."""
    data = json.loads(Path(path).read_text())
    params = SimParams(**data.get("params", {}))
    genome = genome_from_json(json.dumps(data.get("genome", {"modes": []})))
    return params, genome


def save_scene(path: str | Path, params: SimParams, genome: Genome) -> None:
    Path(path).write_text(json.dumps({
        "params": dataclasses.asdict(params),
        "genome": {"modes": [dataclasses.asdict(m) for m in genome.modes]},
    }, indent=2))


class SceneWatcher:
    """The genome live-edit loop — the reference's editor flow `OnValidate
    → EditorApplication.delayCall → OnGenomeChanged → re-init`
    (CellGenome.cs:90-105, ParticleSystemController.cs:357-367) as a
    polling watcher over a scene or genome JSON file: call `poll()` once
    per frame or between run chunks; when the file's (mtime, size)
    changes, the genome is re-parsed and validated and
    `sim.on_genome_changed(genome)` re-initialises the population.

    A torn or partial write (invalid JSON mid-save) is skipped and retried
    on the next poll (`on_error` gets the exception; default: print to
    stderr). Takes a full scene ({params, genome}) or a bare genome
    ({modes: [...]}); only the genome is reloaded (params changes need a
    restart, as the reference's scene fields are frozen in play mode)."""

    def __init__(self, sim, path: str | Path, on_error=None):
        self.sim = sim
        self.path = Path(path)
        self.on_error = on_error
        self._stamp = self._stat()

    def _stat(self):
        try:
            st = self.path.stat()
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    def _report(self, exc: Exception) -> None:
        if self.on_error is not None:
            self.on_error(exc)
        else:
            print(f"[watch] reload of {self.path} failed: {exc}",
                  file=sys.stderr, flush=True)

    def poll(self) -> bool:
        """Check the file; fire on_genome_changed if it changed since the
        last successful observation. Returns True iff the hook fired."""
        stamp = self._stat()
        if stamp is None or stamp == self._stamp:
            return False
        try:
            data = json.loads(self.path.read_text())
            gjson = data["genome"] if "genome" in data else data
            genome = genome_from_json(json.dumps(gjson))
        except (OSError, ValueError, KeyError, TypeError) as exc:
            # A torn write or a bad edit: retry on the next poll.
            self._report(exc)
            return False
        self._stamp = stamp
        self.sim.on_genome_changed(genome)
        return True


def watch_scene(sim, path: str | Path, on_error=None) -> SceneWatcher:
    """A SceneWatcher on `sim` for the JSON at `path`; the caller drives it
    by calling `.poll()` periodically."""
    return SceneWatcher(sim, path, on_error=on_error)


def reference_genome() -> Genome:
    """The authored NewCellGenome.asset config, field-for-field."""
    return Genome((
        GenomeMode(
            mode_name="Mode 0",
            split_interval=5.0,
            is_initial=True,
            parent_make_adhesion=True,
            mode_color=(1.0, 1.0, 1.0, 1.0),
            parent_split_yaw=0.0,
            parent_split_pitch=0.0,
            child_a_mode_index=0,
            child_a_orientation_yaw=90.0,
            child_a_orientation_pitch=0.0,
            child_a_keep_adhesion=True,
            child_b_mode_index=0,
            child_b_orientation_yaw=90.0,
            child_b_orientation_pitch=0.0,
            child_b_keep_adhesion=True,
            adhesion_rest_length=2.96,
            adhesion_spring_stiffness=200.0,
            adhesion_spring_damping=0.0,
            orientation_constraint_strength=0.493,
            max_allowed_angle_deviation=0.0,
        ),
    )).validate_for_simulation()


def reference_scene_params(**overrides) -> SimParams:
    """The shipped scene's inspector values (Particle Simulation.unity:150-178)."""
    base = SimParams(
        capacity=4,
        min_radius=2.0,
        max_radius=2.0,
        spawn_radius=15.0,
        global_drag_multiplier=10.0,
        torque_factor=1.0,
        torque_damping=0.5,
        boundary_friction=0.8,
        rolling_contact_radius_multiplier=5.0,
        density=0.1,
        repulsion_strength=200.0,
        spawn_overlap_offset=0.5,
        split_velocity_magnitude=0.5,
    )
    return base.replace(**overrides) if overrides else base
