"""On-device point-splat rasterizer — the counterpart of
sph_tpu.render.splat (BASELINE config[3]'s "on-device point-splat render";
the reference draws instanced spheres, InstancedParticles.shader +
DrawMeshInstancedIndirect cs:344-347).

Points are projected, summed into their pixel, then spread with a separable
gaussian blur (two depthwise convolutions); the z-buffer is a per-pixel
minimum. Only the final [H, W, 3] frame leaves the device.

Deterministic on the card: a pixel's sum is taken over its points in index
order — a stable sort by pixel id, then one segmented sum — never with
float atomics, so a frame rendered twice is bitwise the same. Masked points
add nothing to any pixel, so they are dropped before projection; the frame
is the same bit for bit as when they are carried through.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sph_tpu_torch.render.image import frame_bytes, write_png

# Projected-size classes of render_points(radius=...): a splat whose
# projected radius is ≤ 1.5 px blurs by 1 px, ≤ 3 by 2, ≤ 6 by 4, else 7.
SIZE_CLASSES = ((1.5, 1), (3.0, 2), (6.0, 4), (float("inf"), 7))


def fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x·y + z in float32 with one rounding, as a fused multiply-add: taken
    in float64, where the product of two float32 is exact."""
    return (x.double() * y.double() + z.double()).float()


def dot3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a · v over the last axis (length 3), as XLA's CPU dot forms
    `a @ v`: a0·v0, then a1·v1 and a2·v2 each added by a fused
    multiply-add. Forming it so keeps the projection bitwise with the JAX
    package's on the CPU, and the same on either device here."""
    acc = a[..., 0] * v[..., 0]
    for i in (1, 2):
        acc = fma(a[..., i], v[..., i], acc)
    return acc


def camera_tensors(camera_params, device):
    """Camera.view_params() → (eye, right, up, forward) f32 tensors on
    `device` and tan_half_fov as a Python float."""
    eye, right, up, forward, tanf = camera_params
    return tuple(torch.as_tensor(np.asarray(v, np.float32), device=device)
                 for v in (eye, right, up, forward)) + (float(tanf),)


def project_points(pos, eye, right, up, forward, tan_half_fov, width,
                   height):
    """World → pixel coordinates + camera-space depth."""
    rel = pos - eye
    x_cam = dot3(rel, right)
    y_cam = dot3(rel, up)
    z_cam = dot3(rel, forward)
    safe_z = torch.clamp_min(z_cam, 1e-6)
    aspect = width / height
    ndc_x = x_cam / (safe_z * tan_half_fov * aspect)
    ndc_y = y_cam / (safe_z * tan_half_fov)
    px = (ndc_x * 0.5 + 0.5) * (width - 1)
    py = (1.0 - (ndc_y * 0.5 + 0.5)) * (height - 1)
    visible = ((z_cam > 1e-3) & (px >= 0) & (px < width) & (py >= 0)
               & (py < height))
    return px, py, z_cam, visible


def _gaussian_kernel(radius_px: int, normalize: bool = True,
                     device="cpu") -> torch.Tensor:
    x = torch.arange(-radius_px, radius_px + 1, dtype=torch.float32,
                     device=device)
    k = torch.exp(-0.5 * (x / max(radius_px * 0.5, 0.5)) ** 2)
    return k / torch.sum(k) if normalize else k


def _blur(img, radius_px: int, normalize: bool = True):
    """Separable gaussian blur over [H, W, C] (two 1D convolutions, each a
    depthwise conv2d with `radius_px` of zero padding on its axis).

    normalize=True preserves total energy (diffusion); normalize=False keeps
    the PEAK at 1 — a point grows into a radius_px-wide disk of comparable
    brightness, which is what screen-space radius scaling wants.

    cuDNN is held to float32 arithmetic (no TF32) and a deterministic
    algorithm, so the card's blur repeats bit for bit.
    """
    if radius_px <= 0:
        return img
    k = _gaussian_kernel(radius_px, normalize, img.device)
    n = k.shape[0]
    c = img.shape[-1]
    x = img.permute(2, 0, 1)[None]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        x = F.conv2d(x, k.view(1, 1, 1, n).expand(c, 1, 1, n),
                     padding=(0, radius_px), groups=c)
        x = F.conv2d(x, k.view(1, 1, n, 1).expand(c, 1, n, 1),
                     padding=(radius_px, 0), groups=c)
    return x[0].permute(1, 2, 0)


def segment_sums(values, segment, keep, n_segments: int) -> torch.Tensor:
    """Per-segment sums of `values` [N, C] over the rows where `keep`, each
    segment added in row order: a stable sort by segment id, then one
    segmented sum (sequential per segment on either device, no atomics).
    Returns [n_segments, C]."""
    rows = torch.nonzero(keep).squeeze(1)
    seg, order = torch.sort(segment[rows], stable=True)
    lengths = torch.bincount(seg, minlength=n_segments)
    return torch.segment_reduce(values[rows[order]], "sum",
                                lengths=lengths, axis=0, unsafe=True)


def _drop_masked(mask, *arrays):
    """The rows of each array (None passes through) where mask holds."""
    if mask is None:
        return arrays
    keep = torch.nonzero(mask).squeeze(1)
    return tuple(None if a is None else a[keep] for a in arrays)


def depth_colors(z, visible):
    """Depth cue: near = bright cyan-white, far = deep blue."""
    zmax = torch.amax(torch.cat([torch.where(visible, z, 0.0),
                                 z.new_zeros(1)]))
    t = torch.clamp(z / (zmax + 1e-6), 0, 1)
    return torch.stack(
        [0.3 + 0.5 * (1 - t), 0.6 + 0.3 * (1 - t), 1.0 - 0.3 * t], dim=-1)


def pixel_ids(px, py, visible, width: int, height: int):
    """Flat pixel id of each point; invisible points get width·height."""
    ix = torch.clamp(px.to(torch.int32), 0, width - 1)
    iy = torch.clamp(py.to(torch.int32), 0, height - 1)
    return torch.where(visible, iy * width + ix, width * height).long()


def splat_sums(pid, z, visible, colors, width: int, height: int, tanf,
               radius=None) -> torch.Tensor:
    """The per-pixel colour sums: [1, H, W, 3] without `radius`, else
    [4, H, W, 3], one per projected-size class (SIZE_CLASSES). One sort
    serves all classes: the key is class·(H·W) + pixel."""
    npix = width * height
    if radius is None:
        sums = segment_sums(colors, pid, visible, npix)
        return sums.view(1, height, width, 3)
    r_px = radius * (height * 0.5) / (torch.clamp_min(z, 1e-6) * tanf)
    cls = torch.zeros_like(pid)
    for hi_edge, _ in SIZE_CLASSES[:-1]:
        cls += r_px > hi_edge
    # A NaN or −inf projected radius falls in no class.
    keep = visible & (r_px > -float("inf"))
    sums = segment_sums(colors, cls * npix + pid, keep,
                        len(SIZE_CLASSES) * npix)
    return sums.view(len(SIZE_CLASSES), height, width, 3)


def blur_classes(sums, radius=None, splat_radius_px: int = 2):
    """Blur the sums of splat_sums and add the classes up in order."""
    if radius is None:
        return _blur(sums[0], splat_radius_px)
    img = torch.zeros_like(sums[0])
    for part, (_, blur_px) in zip(sums, SIZE_CLASSES):
        img = img + _blur(part, blur_px, normalize=False)
    return img


def tone_map(img, exposure=None, background=(0.02, 0.02, 0.05)):
    """Soft tone map over a background; exposure None = auto gain."""
    if exposure is None:
        # Auto gain: brightest pixel maps to ~0.86 after the tone curve,
        # keeping sparse scenes visible and dense ones unsaturated.
        exposure = 2.0 / torch.clamp_min(torch.amax(img), 1e-6)
    img = 1.0 - torch.exp(-exposure * img)
    bg = torch.tensor(background, dtype=torch.float32, device=img.device)
    alpha = torch.clamp(torch.amax(img, dim=-1, keepdim=True) * 4.0, 0.0,
                        1.0)
    return img + (1.0 - alpha) * bg


def render_points(
    pos: torch.Tensor,
    camera_params,
    width: int = 640,
    height: int = 360,
    colors: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
    splat_radius_px: int = 2,
    exposure: float | None = None,   # None = auto-gain from the brightest pixel
    background: tuple[float, float, float] = (0.02, 0.02, 0.05),
    radius: torch.Tensor | None = None,
) -> torch.Tensor:
    """Additive point-splat image [H, W, 3] in [0, 1], on pos's device.

    camera_params: Camera.view_params() tuple. colors: [N, 3] per-particle
    (defaults to depth-cued blue-white). mask: [N] bool for alive particles.
    radius: optional [N] world radii — when given, splats are binned by
    PROJECTED pixel size into a few discrete blur radii (SIZE_CLASSES), so
    near/large particles render bigger (the impostor path in
    render/impostor.py does the exact per-pixel version for cell-scale
    scenes).
    """
    eye, right, up, forward, tanf = camera_tensors(camera_params, pos.device)
    pos, colors, radius = _drop_masked(mask, pos, colors, radius)
    px, py, z, visible = project_points(pos, eye, right, up, forward, tanf,
                                        width, height)
    if colors is None:
        colors = depth_colors(z, visible)
    pid = pixel_ids(px, py, visible, width, height)
    sums = splat_sums(pid, z, visible, colors, width, height, tanf, radius)
    img = blur_classes(sums, radius, splat_radius_px)
    return tone_map(img, exposure, background)


def zbuffer(pos, camera_params, width=640, height=360, mask=None):
    """Nearest-depth z-buffer [H, W] (inf = empty): a per-pixel minimum,
    which no order of the points can change."""
    eye, right, up, forward, tanf = camera_tensors(camera_params, pos.device)
    (pos,) = _drop_masked(mask, pos)
    px, py, z, visible = project_points(pos, eye, right, up, forward, tanf,
                                        width, height)
    pid = pixel_ids(px, py, visible, width, height)
    zed = torch.where(visible, z, float("inf"))
    zb = torch.full((width * height + 1,), float("inf"), dtype=torch.float32,
                    device=pos.device)
    zb.scatter_reduce_(0, pid, zed, "amin")
    return zb[: width * height].view(height, width)


def save_image(img, path: str) -> None:
    """Write an [H, W, 3] float image to PNG."""
    write_png(frame_bytes(img), path)
