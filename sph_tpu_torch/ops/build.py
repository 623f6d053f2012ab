"""Build and load the CUDA kernels in `sph_tpu_torch/csrc/`.

`nvcc` compiles every source (one process per source, all at once) and
links them into one shared library with a plain C interface, loaded with
ctypes. The library goes to `build/sph_tpu_torch/` at
the repository root, named by a hash of the sources and flags, and is built
at first use; a later call in the same process reuses the loaded library.
No `--use_fast_math`: the rebin kernel needs IEEE f32 division (nvcc's
default `-prec-div=true`) and the sweeps IEEE square roots to stay bitwise
equal to their plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

SOURCES = ("fluid_sweep.cu", "rebin.cu", "contact_sweep.cu",
           "expand_rows.cu", "integrate.cu", "adhesion.cu",
           "contact_slots.cu")
HEADERS = ("persistent.cuh",)   # included by the sources; in the hash
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sph_tpu_torch"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    # px, py, pz, occ, out, work, ext, n0, k, c, x, stencil0, stencil1,
    # band_rows, smem_bytes, h2, self_init, scale, stream
    "sph_density_sweep": [_P] * 7 + [_I] * 8 + [_F] * 3 + [_P],
    # px, py, pz, vx, vy, vz, rho, pr2, occ, 3 outputs, work, ext, n0, k, c,
    # x, stencil0, stencil1, band_rows, smem_bytes, h, neg_m_spiky, visc_mc,
    # r2_cut, stream
    "sph_accel_sweep": [_P] * 14 + [_I] * 8 + [_F] * 4 + [_P],
    # p0, p1, p2, occ, codes, dropped_in, dropped, n0, k, c, x, planes,
    # origin0..2, cell, stream
    "sph_rebin_codes": [_P] * 7 + [_I] * 5 + [_F] * 4 + [_P],
    # in[8], out[9], codes, dropped, demand, n0, k, c, x, planes, rest,
    # stream
    "sph_rebin_place": [ctypes.POINTER(_P)] * 2 + [_P] * 3 + [_I] * 5
    + [_F, _P],
    # fields[10], occ, outs[6], cursor, Z, Y, L, K, band_rows,
    # smem_bytes, eps, slip_eps, repulsion, torque_factor, mult, device,
    # stream
    "sph_contact_sweep": [ctypes.POINTER(_P), _P, ctypes.POINTER(_P), _P]
    + [_I] * 6 + [_F] * 5 + [_I, _P],
    # fields[10], occ, outs[6], cursor, Z, Y, L, K, band_rows, smem_bytes,
    # mode, eps, device, stream
    "sph_contact_floor": [ctypes.POINTER(_P), _P, ctypes.POINTER(_P), _P]
    + [_I] * 7 + [_F, _I, _P],
    # Z, Y, L, K, band_rows, smem_bytes, mode, device, grid
    "sph_contact_grid": [_I] * 8 + [ctypes.POINTER(_I)],
    # rows, key, out, n, ncol, slots, fills (host), device, stream
    "sph_expand_rows": [_P] * 3 + [_I] * 3 + [ctypes.POINTER(_F), _I, _P],
    # in[10], out[6], clamped, n, ndim, consts[13] (host), n_obstacles,
    # kinds (host), geometry (host), drag[4] or null, device, stream
    "sph_integrate": [ctypes.POINTER(_P)] * 2 + [_P, _I, _I,
                                                 ctypes.POINTER(_F), _I,
                                                 ctypes.POINTER(_I),
                                                 ctypes.POINTER(_F),
                                                 ctypes.POINTER(_P), _I, _P],
    # raw, occ, rho, prs, pr2, n, consts[5] (host), device, stream
    "sph_density_tail": [_P] * 5 + [_I, ctypes.POINTER(_F), _I, _P],
    # ptrs[16] (host), out, n, b, rows, n_table, anchors_on, dt, device,
    # stream
    "sph_bond_rows": [ctypes.POINTER(_P), _P] + [_I] * 5 + [_F, _I, _P],
    # rows, perm, flags, last, has, zero_bond (or null), b, out, v_in,
    # f_in, tv, tf, cursor, mp, n, stream
    "sph_bond_scan": [_P] * 6 + [_I] + [_P] * 6 + [_I] * 2 + [_P],
    # cid, order, n, k, dead, slots, flat, fits, key, slot_of, overflow,
    # cursor, device, stream
    "sph_contact_slots": [_P] * 2 + [_I] * 4 + [_P] * 6 + [_I, _P],
    # planes[6] (host), slot_of, out, n, slots, stream
    "sph_contact_gather": [ctypes.POINTER(_P), _P, _P, _I, _I, _P],
}


@dataclass
class Library:
    """The loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float     # wall time of the build (0 when the file existed)
    log: str           # nvcc / ptxas output of the build ("" when reused)


_LOADED: Library | None = None


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); cannot build "
                           "the sph_tpu_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _compile(out: Path) -> str:
    """One nvcc per source, all started together, then one link."""
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{Path(src).stem}.o") for src in SOURCES]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / src),
                          "-o", str(obj)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    tmp = out.with_name(f"{tag}.tmp")
    try:
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        r = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                            *(str(o) for o in objs)],
                           capture_output=True, text=True)
        log += r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return log


def library() -> Library:
    """The kernel library, built on first use (raises if it cannot be)."""
    global _LOADED
    if _LOADED is None:
        path = BUILD_DIR / f"libsph_tpu_torch_{source_hash()}.so"
        built = not path.exists()
        t0 = time.perf_counter()
        log = _compile(path) if built else ""
        seconds = time.perf_counter() - t0 if built else 0.0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED = Library(lib=lib, path=path, seconds=seconds, log=log)
    return _LOADED


def check_operands(name: str, tensors, shape, device) -> None:
    """Raise unless every tensor is a contiguous f32 CUDA tensor of `shape`
    on `device`, small enough for the kernels' 32-bit indexing."""
    check_device(name, tensors, device)
    check_layout(name, tensors, shape)


def check_device(name: str, tensors, device) -> None:
    """Raise unless every tensor lies on `device`, a CUDA device."""
    for t in tensors:
        if device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: expected CUDA tensors on {device}, "
                             f"got {t.device}")


def slab_planes(name: str, tensors, rest) -> int:
    """The plane count of a sweep's operands, which may be a halo-padded
    slab of a sharded step: raises unless every tensor is a contiguous,
    16-byte aligned (the staging copies are bulk copies) f32 [planes,
    *rest] tensor with the first tensor's planes, at least one."""
    planes = tensors[0].shape[0] if tensors[0].dim() else 0
    check_layout(name, tensors, (planes, *rest))
    if planes < 1:
        raise ValueError(f"{name}: expected at least one plane")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: expected 16-byte aligned tensors (the "
                         f"staging copies are bulk copies)")
    return planes


def check_layout(name: str, tensors, shape) -> None:
    """Raise unless every tensor is a contiguous f32 tensor of `shape`,
    small enough for the kernels' 32-bit indexing (checked once: every
    tensor has `shape`)."""
    shape = torch.Size(shape)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    if tensors and shape.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {shape.numel()} elements overflow the "
                         f"kernel's 32-bit indexing")


def check_launch(name: str, rc: int) -> None:
    """Raise on a nonzero cudaGetLastError() returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def stream_of(device) -> int:
    """The raw handle of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream
