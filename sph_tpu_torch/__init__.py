"""sph_tpu_torch — the PyTorch + CUDA port of sph_tpu's dense WCSPH fluid path.

Mirrors `sph_tpu`'s layout so every module has one counterpart to be held
against (`sph/kernels.py`, `sph/model.py`, `sph/scenes.py`, `sph/dense.py`,
`engine/fluid.py`, `utils/verify.py`). The Pallas kernels of the dense step
become hand-written CUDA kernels for Hopper (`csrc/`, built by
`ops/build.py`, wrapped by `ops/fluid.py` and `ops/rebin.py`). Imports no
JAX: the JAX package stays the reference and only the tests import both.
"""

__version__ = "0.1.0"
