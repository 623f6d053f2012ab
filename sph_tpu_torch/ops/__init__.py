"""Hand-written CUDA kernels and their wrappers: the dense fluid step
(density, accel, rebin, and its per-slot tail: density_tail, integrate),
the colony contact path (contact_slots, expand, contact, contact_gather)
and the adhesion pass's per-bond rows (bond_rows) and planned accumulate
(bond_scan).

LAUNCHES counts, per kernel, the launches its wrapper made (incremented
only where the kernel is launched, never on the plain CPU route), so a run
can show that its main path went through the kernels. FLOOR_LAUNCHES
counts the stage modes of the contact sweep (ops/contact_floor.py), probes
that no step launches, apart, so that a step's counts stay comparable."""

LAUNCHES = {"density": 0, "accel": 0, "rebin": 0, "contact": 0,
            "expand": 0, "density_tail": 0, "integrate": 0, "bond_rows": 0,
            "bond_scan": 0, "contact_slots": 0, "contact_gather": 0}
FLOOR_LAUNCHES = {"zero": 0, "pads": 0, "screen": 0}
# Per device, a 0-dim int32 tensor there: the most particles that sought
# one cell at any stage of a rebin since the last reset (K3 raises it with
# an atomicMax, the plain rebin with torch.maximum). It stays on the
# device, beside the state's `dropped` and `clamped`, and is not part of
# the state, so checkpoints keep the JAX package's format.
REBIN_PEAK = {}
# Per device, a 0-dim int64 tensor there: the occupied lanes the obstacles'
# push acted on (within h/2 of an obstacle's surface), summed over the steps
# since the last reset (F1 counts them per step, as the plain `_integrate`
# does; the step adds the count here). Outside the state, as REBIN_PEAK.
OBSTACLE_PUSHED = {}


def launch_counts(**expected) -> dict:
    """A launch expectation over LAUNCHES' kernels: the counts named in
    `expected` and 0 for every other kernel, so that an expectation names
    only the kernels that run. A name that is no kernel raises KeyError."""
    unknown = sorted(set(expected) - set(LAUNCHES))
    if unknown:
        raise KeyError(f"not kernels of LAUNCHES: {unknown}")
    return {name: expected.get(name, 0) for name in LAUNCHES}


def reset_launches() -> None:
    for counts in (LAUNCHES, FLOOR_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _counter(table: dict, device, dtype):
    """table's 0-dim counter of `device` (made at 0 on first use)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in table:
        table[device] = torch.zeros((), dtype=dtype, device=device)
    return table[device]


def rebin_peak(device):
    """The rebin demand peak of `device` (made at 0 on first use)."""
    import torch

    return _counter(REBIN_PEAK, device, torch.int32)


def reset_rebin_peak() -> None:
    for peak in REBIN_PEAK.values():
        peak.zero_()


def obstacle_pushed(device):
    """The running total of pushed lanes of `device` (made at 0 on first
    use)."""
    import torch

    return _counter(OBSTACLE_PUSHED, device, torch.int64)


def reset_obstacle_pushed() -> None:
    for total in OBSTACLE_PUSHED.values():
        total.zero_()
