"""Port vs reference for the render layer: the camera, the point splats, the
z-buffer, the sphere impostors, the split-plane ring, the overlay's draw
commands and their rasteriser, the PNG writer and
`FluidSimulation.render_frame`; and `core/quat.identity`.

Inputs are made from a numpy seed; JAX runs on the CPU, eagerly, as its
own render tests run it. Tolerances: the camera, `quat.identity` and the
z-buffer are bitwise (the same numpy or order-free operations); the
projection rtol 1e-6 / atol 1e-4 px; frames atol 1e-5 per channel
(`render_frame` 1e-4); ring points atol 1e-6; the overlay's commands equal
the ImageDraw calls the JAX package makes (coordinates within 1e-3 px,
colours and widths exact); the rasteriser draws each primitive within one
pixel of ImageDraw's pixels for it, both ways (Chebyshev distance)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from sph_tpu.core import quat as jquat
from sph_tpu.engine.fluid import FluidSimulation as JaxFluidSimulation
from sph_tpu.render import impostor as jimp
from sph_tpu.render import overlay as jov
from sph_tpu.render import splat as jsplat
from sph_tpu.render.camera import Camera as JaxCamera
from sph_tpu_torch.core import quat
from sph_tpu_torch.engine.fluid import FluidSimulation
from sph_tpu_torch.render import impostor, overlay, raster, splat
from sph_tpu_torch.render.camera import Camera
from sph_tpu_torch.render.image import Frame, read_png
from sph_tpu_torch.sph import scenes
from sph_tpu_torch.sph.dense import DenseFluidState
from sph_tpu_torch.utils.convert import params_from_jax, state_from_numpy

torch.set_num_threads(1)

SIZES = [(64, 64), (160, 90)]


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def view(seed=0):
    """A camera looking at the origin from a seeded direction."""
    rng = np.random.default_rng(seed)
    cam = JaxCamera()
    cam.focus_on((0.0, 0.0, 0.0), distance=12.0)
    cam.look(*rng.uniform(-8, 8, 2))
    return cam.view_params()


def cloud(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "pos": (rng.normal(size=(n, 3)) * 3).astype(np.float32),
        "colors": rng.uniform(size=(n, 3)).astype(np.float32),
        "radius": rng.uniform(0.05, 1.5, n).astype(np.float32),
        "mask": rng.uniform(size=n) > 0.2,
    }


def test_quat_identity_bitwise():
    for shape in [(), (5,), (3, 2)]:
        got = quat.identity(shape, device="cpu")
        want = np.asarray(jquat.identity(shape))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_camera_bitwise():
    """The copied camera equals the reference's through a sequence of every
    control, including pixel_ray and view_params."""
    cams = [cls(position=np.array([5.0, 3.0, -20.0], np.float32))
            for cls in (JaxCamera, Camera)]
    steps = [
        lambda c: c.look(13.0, -7.0),
        lambda c: c.move(0.3, forward=1.0, strafe=-0.5, lift=0.25),
        lambda c: c.move(0.2, forward=-1.0, sprint=True),
        lambda c: c.zoom(1.7),
        lambda c: c.look(0.0, 1000.0),                 # pitch clamp
        lambda c: c.toggle_orbit(target=(1.0, 2.0, 3.0)),
        lambda c: c.orbit(0.1),
        lambda c: c.zoom(2.5),
        lambda c: c.orbit(0.37, speed_deg=45.0),
        lambda c: c.toggle_orbit(),
        lambda c: c.focus_on((1.0, -2.0, 4.0), distance=7.0),
        lambda c: c.look(-3.3, 2.2),
    ]
    for step in steps:
        for c in cams:
            step(c)
        a, b = cams
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(b, f.name),
                                          getattr(a, f.name), err_msg=f.name)
        for x, y in zip(a.view_params(), b.view_params()):
            np.testing.assert_array_equal(y, x)
        for px, py in [(0.0, 0.0), (319.5, 179.5), (613.0, 41.0)]:
            for x, y in zip(a.pixel_ray(px, py, 640, 360),
                            b.pixel_ray(px, py, 640, 360)):
                np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("width,height", SIZES)
def test_project_points(width, height):
    c = cloud(500, 1)
    eye, r, u, f, tanf = view(1)
    want = jsplat.project_points(jnp.asarray(c["pos"]), *map(jnp.asarray, (
        eye, r, u, f)), tanf, width, height)
    got = splat.project_points(T(c["pos"]), *map(T, (eye, r, u, f)), tanf,
                               width, height)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-4)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


OPTIONS = {
    "plain": (),
    "radius": ("radius",),
    "colors+mask": ("colors", "mask"),
    "radius+colors+mask": ("radius", "colors", "mask"),
}


@pytest.mark.parametrize("width,height", SIZES)
@pytest.mark.parametrize("options", list(OPTIONS))
def test_render_points(options, width, height):
    c = cloud(400, 2)
    vp = view(2)
    kw = {k: c[k] for k in OPTIONS[options]}
    want = np.asarray(jsplat.render_points(
        jnp.asarray(c["pos"]), vp, width, height,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = splat.render_points(T(c["pos"]), vp, width, height,
                              **{k: T(v) for k, v in kw.items()})
    assert got.shape == (height, width, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("width,height", SIZES)
def test_zbuffer(width, height):
    c = cloud(400, 3)
    vp = view(3)
    for mask in (None, c["mask"]):
        want = np.asarray(jsplat.zbuffer(
            jnp.asarray(c["pos"]), vp, width, height,
            mask=None if mask is None else jnp.asarray(mask)))
        got = splat.zbuffer(T(c["pos"]), vp, width, height,
                            mask=None if mask is None else T(mask))
        np.testing.assert_array_equal(got.numpy(), want)
        assert np.isfinite(want).any()


@pytest.mark.parametrize("show_dot", [True, False])
def test_render_spheres(show_dot):
    rng = np.random.default_rng(4)
    n = 50
    pos = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    radius = rng.uniform(0.3, 0.9, n).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    vp = view(4)
    want = np.asarray(jimp.render_spheres(
        *map(jnp.asarray, (pos, radius, rot, colors)), vp, 160, 90,
        mask=jnp.asarray(mask), show_dot=show_dot))
    got = impostor.render_spheres(*map(T, (pos, radius, rot, colors)), vp,
                                  160, 90, mask=T(mask), show_dot=show_dot)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    covered = np.abs(want - np.array([0.02, 0.02, 0.05])).sum(-1) > 1e-3
    assert covered.sum() > 500


def test_split_plane_ring_points():
    rng = np.random.default_rng(5)
    for _ in range(4):
        center = rng.normal(size=3).astype(np.float32)
        rot = rng.normal(size=4).astype(np.float32)
        rot /= np.linalg.norm(rot)
        yaw, pitch = rng.uniform(-180, 180), rng.uniform(-80, 80)
        want = jov.split_plane_ring_points(center, rot, yaw, pitch)
        got = overlay.split_plane_ring_points(center, rot, yaw, pitch)
        assert got.dtype == np.float32 and got.shape == (49, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- the overlay's commands and their rasteriser -----------------------------


def overlay_scene(seed=6, n_bonds=40):
    """Bond lines, labels, a drag and a ring around the origin, some of
    them out of view."""
    rng = np.random.default_rng(seed)
    zone = [(0, 1, 0), (0, 0, 1), (1, 0, 0)]
    bonds = []
    for _ in range(n_bonds):
        a = rng.normal(size=3) * 4
        b = a + rng.normal(size=3)
        bonds.append({
            "a": a.tolist(), "b": b.tolist(),
            "midpoint": ((a + b) / 2).tolist(),
            "color_a": zone[rng.integers(3)], "color_b": zone[rng.integers(3)],
            "anchor_a": (a + rng.normal(size=3) * 0.3).tolist(),
            "anchor_b": (b + rng.normal(size=3) * 0.3).tolist(),
            "child_to_child": bool(rng.integers(2)),
        })
    bonds[0]["a"] = [0.0, 0.0, -100.0]            # behind the camera
    labels = [(rng.normal(size=3).astype(np.float32) * 4,
               f"{rng.integers(0, 120):02d}.{rng.integers(0, 120):02d}."
               f"{'AB'[rng.integers(2)]}") for _ in range(12)]
    ring = jov.split_plane_ring_points(
        np.float32([1.0, 0.5, 0.0]), np.float32([0, 0, 0, 1]), 30.0, 10.0)
    return dict(labels=labels, bond_lines=bonds,
                drag_target=np.float32([1.5, -1.0, 0.5]),
                drag_from=np.float32([0.5, 0.0, 0.2]), split_ring=ring,
                show_anchors=True)


def recorded_calls(monkeypatch, draw):
    """Run draw() with ImageDraw's line, ellipse and text recorded (and
    still drawn): [(kind, coordinates, colour or text, width or colour)]."""
    calls = []
    real = {k: getattr(ImageDraw.ImageDraw, k)
            for k in ("line", "ellipse", "text")}

    def line(self, xy, fill=None, width=0, **kw):
        calls.append(("line", tuple(tuple(map(float, p)) for p in xy),
                      tuple(fill), width))
        return real["line"](self, xy, fill=fill, width=width, **kw)

    def ellipse(self, xy, fill=None, outline=None, width=1):
        calls.append(("ellipse", tuple(map(float, xy)), tuple(outline),
                      width))
        return real["ellipse"](self, xy, fill=fill, outline=outline,
                               width=width)

    def text(self, xy, text, fill=None, *a, **kw):
        calls.append(("text", tuple(map(float, xy)), text, tuple(fill)))
        return real["text"](self, xy, text, fill, *a, **kw)

    for name, fn in (("line", line), ("ellipse", ellipse), ("text", text)):
        monkeypatch.setattr(ImageDraw.ImageDraw, name, fn)
    try:
        out = draw()
    finally:
        monkeypatch.undo()
    return calls, out


def assert_same_calls(got, want):
    assert [c[0] for c in got] == [c[0] for c in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.ravel(g[1]), np.ravel(w[1]), rtol=0,
                                   atol=1e-3, err_msg=str(w))
        assert g[2:] == w[2:], (g, w)


def test_overlay_commands_equal_jax_draw_calls(monkeypatch):
    cam = JaxCamera()
    cam.focus_on((0.0, 0.0, 0.0), distance=12.0)
    scene = overlay_scene()
    img = np.full((180, 320, 3), 0.1, np.float32)
    want, _ = recorded_calls(
        monkeypatch, lambda: jov.draw_overlays(img, cam, **scene))
    got = overlay.overlay_commands(cam, 320, 180, **scene).calls()
    kinds = {c[0] for c in want}
    assert kinds == {"line", "ellipse", "text"} and len(want) > 100
    assert_same_calls(got, want)


def dilated(mask):
    """mask grown by one pixel in each of the 8 directions."""
    p = np.pad(mask, 1)
    h, w = mask.shape
    return np.any([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1)], axis=0)


def primitives(kind, rng):
    """(ImageDraw call, port DrawList) pairs of one kind of primitive."""
    out = []
    for _ in range(40):
        if kind.startswith("line"):
            w = int(kind[-1])
            xy = rng.uniform(2, 58, 4).astype(np.float32)
            out.append((lambda d, xy=xy, w=w: d.line(
                [tuple(xy[:2]), tuple(xy[2:])], fill=(255, 0, 0), width=w),
                raster.DrawList.of(raster.LINE, xy, (255, 0, 0), w)))
        elif kind.startswith("ellipse"):
            r, w = {"ellipse3": (3, 1), "ellipse6": (6, 2)}[kind]
            cx, cy = rng.uniform(8, 50, 2).astype(np.float32)
            box = [cx - r, cy - r, cx + r, cy + r]
            out.append((lambda d, box=box, w=w: d.ellipse(
                box, outline=(0, 255, 0), width=w),
                raster.DrawList.of(raster.ELLIPSE, box, (0, 255, 0), w)))
        else:
            xy = rng.uniform(0, 40, 2).astype(np.float32)
            text = (f"{rng.integers(0, 120):02d}.{rng.integers(0, 120):02d}."
                    f"{'AB'[rng.integers(2)]}")
            out.append((lambda d, xy=xy, text=text: d.text(
                tuple(xy), text, fill=(255, 255, 160)),
                raster.DrawList.of(raster.TEXT, [*xy, 0, 0],
                                   (255, 255, 160), 0, [text])))
    return out


@pytest.mark.parametrize("kind", ["line1", "line2", "ellipse3", "ellipse6",
                                  "text"])
def test_rasterizer_within_a_pixel_of_pil(kind):
    """Each primitive alone on a black 80×60 canvas: every pixel the port
    draws is within one pixel of one PIL draws, and the other way round."""
    rng = np.random.default_rng(7)
    for pil_draw, cmds in primitives(kind, rng):
        im = Image.new("RGB", (80, 60))
        pil_draw(ImageDraw.Draw(im))
        want = np.asarray(im).any(-1)
        arr = np.zeros((60, 80, 3), np.uint8)
        got = raster.rasterize(arr, cmds).any(-1)
        assert want.any() and got.any()
        assert not (got & ~dilated(want)).any(), cmds.calls()
        assert not (want & ~dilated(got)).any(), cmds.calls()


def test_font_is_pils_default_font():
    """The glyph table is Pillow's default font drawn at a whole-pixel
    origin, thresholded at 32/255, with its advances."""
    from PIL import ImageFont

    font = ImageFont.load_default()
    for ch, (adv, top, rows) in raster.GLYPHS.items():
        im = Image.new("L", (16, 16))
        ImageDraw.Draw(im).text((0, 0), ch, fill=255)
        mask = np.asarray(im) >= 32
        want = np.zeros_like(mask)
        for r, bits in enumerate(rows):
            for col in range(8):
                want[top + r, col] = bits >> col & 1
        np.testing.assert_array_equal(mask, want, err_msg=ch)
        assert font.getlength(ch) == adv, ch


def test_png_reads_back_through_pil(tmp_path):
    rng = np.random.default_rng(8)
    arr = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    Frame(arr).save(path)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(read_png(path), arr)
    img = rng.uniform(-0.2, 1.2, (20, 30, 3)).astype(np.float32)
    splat.save_image(T(img), str(tmp_path / "p.png"))
    jsplat.save_image(jnp.asarray(img), str(tmp_path / "j.png"))
    np.testing.assert_array_equal(read_png(str(tmp_path / "p.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))


def test_render_frame_matches_jax(tmp_path):
    """A small 3D dam break, its positions jittered from a seed, rendered by
    both packages' FluidSimulation.render_frame."""
    jsim = JaxFluidSimulation.from_scene("dam_break_3d", n_target=3000,
                                         substeps=5)
    arrays = {f.name: np.array(getattr(jsim.dstate, f.name))
              for f in dataclasses.fields(DenseFluidState)}
    rng = np.random.default_rng(9)
    occ = arrays["occ"] > 0.5
    for f in ("px", "py", "pz"):
        arrays[f][occ] += rng.uniform(-0.01, 0.01, occ.sum()).astype(
            np.float32)
    jsim.dstate = jsim.dstate.replace_fields(
        **{f: jnp.asarray(arrays[f]) for f in ("px", "py", "pz")})
    sim = FluidSimulation(
        *scenes.dam_break_3d(n_target=3000), substeps=5, device="cpu")
    assert sim.params == params_from_jax(dataclasses.asdict(jsim.params))
    sim.dstate = state_from_numpy(arrays, device="cpu")
    want = np.asarray(jsim.render_frame(str(tmp_path / "j.png")))
    got = sim.render_frame(str(tmp_path / "p.png"))
    assert got.shape == (450, 800, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert want.max() > 0.3
    png = read_png(str(tmp_path / "p.png"))
    assert (np.abs(png.astype(int) - np.asarray(
        Image.open(tmp_path / "j.png")).astype(int)) <= 1).all()
