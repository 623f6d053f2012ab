"""The port's command-line app and profiling utilities on the CPU:
`python -m sph_tpu_torch.app fluid|cells|view` called in process as
`main([..., "--device", "cpu"])` at tiny sizes; `step_breakdown` against
the JAX package's (the same keys, finite times); `trace` writing a Chrome
trace."""

import json
import os
import re

import numpy as np
import torch
from PIL import Image

from sph_tpu.sph.dense import make_dense_spec as jax_make_dense_spec
from sph_tpu.sph.dense import pack as jax_pack
from sph_tpu.sph.scenes import dam_break_2d as jax_dam_break_2d
from sph_tpu.utils.profiling import step_breakdown as jax_step_breakdown
from sph_tpu_torch.app.__main__ import main
from sph_tpu_torch.render.image import read_png
from sph_tpu_torch.sph.dense import make_dense_spec, pack
from sph_tpu_torch.sph.scenes import dam_break_2d
from sph_tpu_torch.utils.profiling import step_breakdown, trace

torch.set_num_threads(1)


def json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_app_fluid_on_cpu(tmp_path, capsys):
    out = tmp_path / "fluid"
    ckpt = str(tmp_path / "fluid.npz")
    rc = main(["fluid", "--scene", "dam_break_2d", "--n", "200", "--steps",
               "20", "--substeps", "10", "--render-every", "10", "--out",
               str(out), "--checkpoint", ckpt, "--device", "cpu"])
    assert rc == 0
    metrics = json_lines(capsys.readouterr().out)
    assert [m["step"] for m in metrics] == [10, 20]
    assert all(m["dropped"] == 0 and m["n_particles"] > 0 for m in metrics)
    frames = sorted(os.listdir(out))
    assert frames == ["frame_00000.png", "frame_00001.png"]
    for f in frames:
        px = read_png(str(out / f))
        assert px.shape == (450, 800, 3) and px.max() > 76
        np.testing.assert_array_equal(np.asarray(Image.open(out / f)), px)
    assert os.path.exists(ckpt)


def test_app_cells_on_cpu(tmp_path, capsys):
    out = tmp_path / "cells"
    rc = main(["cells", "--capacity", "16", "--steps", "40", "--dt", "0.5",
               "--render-every", "20", "--labels", "--out", str(out),
               "--device", "cpu"])
    assert rc == 0
    metrics = json_lines(capsys.readouterr().out)
    assert [m["step"] for m in metrics] == [20, 40]
    assert metrics[-1]["active_particles"] > 1
    assert all(re.fullmatch(r"\d\d+\.\d\d+\.[AB]", i)
               for i in metrics[-1]["ids"])
    frames = sorted(os.listdir(out))
    assert frames == ["cells_00000.png", "cells_00001.png"]
    assert read_png(str(out / frames[-1])).shape == (450, 800, 3)


def test_app_view_on_cpu(tmp_path, capsys):
    script = tmp_path / "script.json"
    script.write_text(json.dumps({
        "0": [{"type": "mouse_down", "x": 160, "y": 90}],
        "1": [{"type": "mouse_move", "x": 200, "y": 90}],
        "3": [{"type": "mouse_up"}, {"type": "orbit"}]}))
    out = tmp_path / "view"
    rc = main(["view", "--capacity", "16", "--frames", "5", "--width", "320",
               "--height", "180", "--script", str(script), "--render",
               "--out", str(out), "--device", "cpu"])
    assert rc == 0
    last = json_lines(capsys.readouterr().out)[-1]
    assert last["frame"] == 4 and last["drag_slot"] == -1
    assert last["active"] == 1 and last["fps"] > 0
    assert sorted(os.listdir(out)) == [f"view_{i:05d}.png" for i in range(5)]


def test_step_breakdown_keys_match_jax():
    state, params = dam_break_2d(n_target=200)
    params = params.replace(dense_k=4, cell_factor=1.2)
    spec = make_dense_spec(params, k=4, cell_factor=1.2)
    got = step_breakdown(pack(state, params, spec, device="cpu"), params,
                         spec, n=1, sub=2)
    jstate, jparams = jax_dam_break_2d(n_target=200)
    jparams = jparams.replace(dense_k=4, cell_factor=1.2)
    jspec = jax_make_dense_spec(jparams, k=4, cell_factor=1.2)
    want = jax_step_breakdown(jax_pack(jstate, jparams, jspec), jparams,
                              jspec, n=1, sub=2)
    # The JAX package adds per-lane rates to its times; the port reports
    # the times alone.
    assert sorted(got) == sorted(k for k in want if k.endswith("_ms"))
    assert all(np.isfinite(v) and v >= 0 for v in got.values())
    assert got["total_ms"] == got["full_step_ms"] > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        torch.ones(128, 128).mul(2.0).sum()
    path = tmp_path / "trace.json"
    assert path.exists()
    assert "traceEvents" in json.loads(path.read_text())
