"""The card a run measures, and the guard that the run loads no JAX."""

from __future__ import annotations

import subprocess
import sys

# Top-level module names a run may not hold: JAX and the JAX package the
# port was made from (its name is the port's without "_torch").
FORBIDDEN = ("jax", "jaxlib", "flax", "sph_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in sys.modules that are FORBIDDEN, compared whole:
    `sph_tpu_torch` is not `sph_tpu`."""
    names = {m.split(".", 1)[0] for m in (modules if modules is not None
                                          else list(sys.modules))}
    return sorted(n for n in names if n in FORBIDDEN)


def require_cards(n: int) -> None:
    """Exit with code 3 unless PyTorch sees at least n CUDA cards."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark measures the card "
                         "and has no CPU fallback")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell asks for {n} card(s); "
                         f"{torch.cuda.device_count()} visible")


def smi(fields: str) -> str:
    """The first card's `nvidia-smi --query-gpu=<fields>` line, or the
    error in brackets."""
    try:
        r = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"[nvidia-smi: {e}]"
    if r.returncode != 0:
        return f"[nvidia-smi rc {r.returncode}]"
    return r.stdout.strip().splitlines()[0]


def card_state() -> str:
    return smi("name,power.limit,power.draw,clocks.sm,clocks.mem,"
               "temperature.gpu")
