"""Hand-written CUDA kernels of the dense step and their wrappers.

LAUNCHES counts, per kernel, the launches its wrapper made (incremented
only where the kernel is launched, never on the plain CPU route), so a run
can show that its main path went through the kernels."""

LAUNCHES = {"density": 0, "accel": 0, "rebin_stage": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
