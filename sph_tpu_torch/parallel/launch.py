"""Start a torch.distributed world of ranks on this host: the port's
counterpart of building a JAX Mesh over `jax.devices()`.

    from sph_tpu_torch.parallel.launch import spawn
    results = spawn(fn, world=4, backend="gloo", device="cpu",
                    init_file="/path/to/fresh/file", args=(...))

Each rank is a fresh process (the `spawn` start method: no state is
inherited, so `fn` must be importable by module path and its arguments and
result picklable). `fn(*args)` runs once the rank has joined the world, and
builds its mesh there (parallel.dist.Mesh and its builders). A rank that
raises, dies or outlives the time limit fails the whole run: the others
are killed and `spawn` raises.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def _rank_main(rank, world, backend, device, init_file, timeout, results):
    try:
        with open(f"{init_file}.job", "rb") as f:
            fn, args = pickle.load(f)
        # One intra-op thread a rank: the ranks of a world share the host.
        torch.set_num_threads(1)
        if device == "cuda":
            # Card r mod count: more ranks than cards share the cards.
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        out = fn(*args)
        dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def spawn(fn, world: int, backend: str, device: str, init_file: str,
          args=(), timeout: float = 600.0) -> list:
    """Run fn(*args) on `world` ranks of one torch.distributed world and
    return their results in rank order.

    backend: "nccl" (one card per rank: it refuses two ranks on one card)
    or "gloo" (ranks on the CPU, or sharing cards; CUDA tensors then
    travel through host buffers). Never switched by itself.
    device: "cuda" or "cpu"; with "cuda", rank r's current device is card
    r mod count, and the kernel library is built here, once, before any
    rank starts (ranks building one library at once would race).
    init_file: the rendezvous file (file:// init), fresh for each world;
    the job goes to the ranks through `<init_file>.job`.
    timeout: seconds for the whole run; the ranks' collectives time out
    after it too. Each rank runs torch with one intra-op thread."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' asked for, but no CUDA device "
                               "is visible")
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(f"nccl needs a card per rank: {world} ranks, "
                             f"{torch.cuda.device_count()} cards")
        from sph_tpu_torch.ops.build import library

        library()
    elif backend == "nccl":
        raise ValueError("nccl moves CUDA tensors only; use gloo on the CPU")
    # The job goes through a file: a spawned process's own arguments come
    # through a pipe that the parent fills while the child imports, so
    # large ones would start the ranks one after another.
    with open(f"{init_file}.job", "wb") as f:
        pickle.dump((fn, args), f)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, device, init_file,
                               timeout, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    dead_since = None
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(out)} of {world} ranks "
                                   f"still running after {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                # A rank killed from outside (or crashed) sends nothing;
                # one that raised sends its traceback before it exits.
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead and dead_since is None:
                    dead_since = time.monotonic()
                if dead and time.monotonic() - dead_since > 5.0:
                    raise RuntimeError(f"ranks {dead} exited without a "
                                       f"result (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        _stop(procs)
        os.unlink(f"{init_file}.job")
    return [out[r] for r in range(world)]
