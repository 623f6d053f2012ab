"""Port vs reference for the cell frame and the viewer loop: one colony
state (the reference scene grown for 24 coarse steps in the JAX package,
then carried across with `utils.convert.colony_from_jax`) rendered by both
packages' `render_cells_frame`, and driven through the same scripted
`ViewerLoop` session (press on a cell's pixel, drag, hold, release).

Tolerances: the impostor image atol 1e-5 per channel; the overlay's
commands as in tests/test_torch_render.py (coordinates within 1e-3 px,
colours and widths exact); the frames' bytes within 1 where neither
package drew an overlay (a 1e-5 difference may cross a ×255 truncation);
the pick slot, `drag_slot` and the counts exact each frame; positions at
tests/test_torch_simulation.py's rtol 1e-4 / atol 1e-5·max|x|."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_tpu import Simulation as JaxSimulation
from sph_tpu.app.viewer import ViewerLoop as JaxViewerLoop
from sph_tpu.core import types as jtypes
from sph_tpu.engine import config as jconfig
from sph_tpu.render import impostor as jimp
from sph_tpu.render import overlay as jov
from sph_tpu_torch.app.viewer import ViewerLoop, load_script
from sph_tpu_torch.engine.simulation import Simulation
from sph_tpu_torch.render import overlay
from sph_tpu_torch.render.image import frame_bytes, read_png
from sph_tpu_torch.utils.convert import colony_from_jax
from test_torch_render import assert_same_calls, recorded_calls
from test_torch_simulation import close

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grown():
    """(JAX params, genome, the JAX state after 24 steps of 0.5 s)."""
    p = jconfig.reference_scene_params(capacity=16).replace(
        dt=0.5, max_splits_per_step=8, max_bonds=64)
    g = jconfig.reference_genome()
    jsim = JaxSimulation(g, p, scan_chunk=2)
    jsim.step(24)
    return p, g, jsim.state


def pair(grown, **changes):
    """A JAX sim and a port sim (on the CPU) at a copy of the grown state,
    with `changes` to the params."""
    p, g, st = grown
    p = p.replace(**changes)
    jsim = JaxSimulation(g, p, scan_chunk=4)
    jsim.state = jax.tree_util.tree_map(jnp.copy, st)
    tst, tp, tg = colony_from_jax(jtypes.state_to_numpy(st),
                                  dataclasses.asdict(p),
                                  jconfig.genome_to_json(g), device="cpu")
    sim = Simulation(tg, tp, device="cpu")
    sim.state = tst
    return jsim, sim


def test_render_cells_frame_matches_jax(grown, monkeypatch):
    jsim, sim = pair(grown)
    assert int(sim.state.active_count) >= 3
    assert int(sim.state.bonds.active.sum()) >= 2
    for s in (jsim, sim):
        s.set_drag(1, (5.0, 5.0, 0.0), 100.0)
        s.last_selected = 1
    kw = dict(show_labels=True, show_split_rings=True, show_anchors=True)
    calls, jframe = recorded_calls(
        monkeypatch, lambda: jov.render_cells_frame(jsim, **kw))
    cam = overlay.default_camera(sim)
    inputs = overlay.overlay_inputs(sim, True, True, True)
    got = overlay.overlay_commands(cam, 800, 450, show_anchors=True,
                                   **inputs).calls()
    assert {c[0] for c in calls} == {"line", "ellipse", "text"}
    assert_same_calls(got, calls)

    n_modes = len(jsim.genome.modes)
    colors = jnp.asarray(jsim.genome_dev.mode_color[:, :3])[
        jnp.clip(jsim.state.mode, 0, n_modes - 1)]
    mask = jnp.arange(jsim.state.capacity) < jsim.state.active_count
    jimg = np.asarray(jimp.render_spheres(
        jsim.state.pos, jsim.state.radius, jsim.state.rot, colors,
        cam.view_params(), width=800, height=450, mask=mask))
    img = overlay.cells_image(sim, cam)
    np.testing.assert_allclose(img.numpy(), jimg, rtol=0, atol=1e-5)

    frame = np.asarray(overlay.render_cells_frame(sim, **kw))
    jframe = np.asarray(jframe)
    base = frame_bytes(img)
    jbase = frame_bytes(jimg)
    plain = (frame == base).all(-1) & (jframe == jbase).all(-1)
    assert plain.mean() > 0.9
    assert (np.abs(frame.astype(int) - jframe.astype(int))[plain] <= 1).all()


def test_scripted_viewer_session_matches_jax(grown, tmp_path):
    """Press on cell 1's pixel, drag it right over three frames, hold,
    release, at the reference's dt of 1/60 s: both loops pick the same
    slot, hold the same drag slot each frame, and move the colony alike;
    the dragged cell closes on its target."""
    jsim, sim = pair(grown, dt=1 / 60)
    w, h = 320, 180
    v = ViewerLoop(sim, width=w, height=h, substeps=4)
    jv = JaxViewerLoop(jsim, width=w, height=h, substeps=4)
    pos1 = sim.state.pos[1].numpy()
    px, py, vis = overlay._project(pos1[None], v.camera, w, h)
    assert vis[0]
    x, y = int(round(float(px[0]))), int(round(float(py[0])))
    script = {0: [{"type": "mouse_down", "x": x, "y": y}],
              1: [{"type": "mouse_move", "x": x + 15, "y": y}],
              2: [{"type": "mouse_move", "x": x + 30, "y": y}],
              3: [{"type": "mouse_move", "x": x + 45, "y": y - 10}],
              7: [{"type": "mouse_up"}]}
    for i in range(9):
        frame = v.frame(script.get(i, []))
        jv.frame(script.get(i, []))
        assert v.drag_slot == jv.drag_slot, i
        assert sim.last_selected == jsim.last_selected, i
        assert int(sim.state.active_count) == int(jsim.state.active_count)
        assert int(sim.state.drag_input.selected_slot) == int(
            jsim.state.drag_input.selected_slot)
        close(sim.state.pos.numpy(), np.asarray(jsim.state.pos),
              err_msg=f"frame {i}")
        if i == 0:
            assert v.drag_slot == 1
            np.testing.assert_allclose(v.drag_distance, jv.drag_distance,
                                       rtol=1e-6)
        if i == 3:
            target = sim.state.drag_input.target.numpy()
            gap = np.linalg.norm(sim.state.pos[1].numpy() - target)
        if i == 6:
            assert np.linalg.norm(sim.state.pos[1].numpy() - target) < gap
    assert v.drag_slot == -1 and v.frame_count == 9
    assert np.asarray(frame).shape == (h, w, 3)

    # The run loop: a script file, frames to disk.
    path = tmp_path / "script.json"
    path.write_text('{"0": [{"type": "mouse_down", "x": %d, "y": %d}], '
                    '"2": [{"type": "mouse_up"}]}' % (x, y))
    stats = v.run(3, script=load_script(str(path)), out_dir=str(tmp_path))
    assert [s["frame"] for s in stats] == [0, 1, 2]
    held = [s["drag_slot"] for s in stats]
    assert held[0] >= 0 and held == [held[0], held[0], -1]
    assert read_png(str(tmp_path / "view_00002.png")).shape == (h, w, 3)


def test_blit_ansi_matches_jax(capsys):
    """The terminal front-end writes the same escape codes as JAX's."""
    from sph_tpu.app.viewer import _blit_ansi as jax_blit
    from sph_tpu_torch.app.viewer import _blit_ansi

    arr = np.random.default_rng(10).integers(0, 256, (24, 40, 3),
                                             dtype=np.uint8)
    jax_blit(arr, 12.5, cols=20)
    want = capsys.readouterr().out
    _blit_ansi(arr, 12.5, cols=20)
    got = capsys.readouterr().out
    assert got == want and "▀" in got and "fps:  12.5" in got
