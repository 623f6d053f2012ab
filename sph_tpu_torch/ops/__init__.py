"""Hand-written CUDA kernels and their wrappers: the dense fluid step
(density, accel, rebin) and the colony contact path (contact,
expand).

LAUNCHES counts, per kernel, the launches its wrapper made (incremented
only where the kernel is launched, never on the plain CPU route), so a run
can show that its main path went through the kernels."""

LAUNCHES = {"density": 0, "accel": 0, "rebin": 0, "contact": 0,
            "expand": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
