"""Hand-written CUDA kernels and their wrappers: the dense fluid step
(density, accel, rebin) and the colony contact path (contact,
expand).

LAUNCHES counts, per kernel, the launches its wrapper made (incremented
only where the kernel is launched, never on the plain CPU route), so a run
can show that its main path went through the kernels. FLOOR_LAUNCHES
counts the stage modes of the contact sweep (ops/contact_floor.py), probes
that no step launches, apart, so that a step's counts stay comparable."""

LAUNCHES = {"density": 0, "accel": 0, "rebin": 0, "contact": 0,
            "expand": 0}
FLOOR_LAUNCHES = {"zero": 0, "pads": 0, "screen": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, FLOOR_LAUNCHES):
        for name in counts:
            counts[name] = 0
