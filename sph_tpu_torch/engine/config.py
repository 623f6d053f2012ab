"""JSON config I/O for SimParams and Genome, and the reference scene — the
counterpart of sph_tpu.engine.config, whose JSON it reads and writes
unchanged.

`reference_genome()` is the authored NewCellGenome.asset instance
(splitInterval 5, parentMakeAdhesion on, both children keep adhesion and
stay mode 0, child yaws 90°, restLength 2.96, stiffness 200, damping 0,
orientation strength 0.493); `reference_scene_params()` the shipped scene
values (Particle Simulation.unity:150-178). The genome live-edit watcher
(SceneWatcher) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
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
