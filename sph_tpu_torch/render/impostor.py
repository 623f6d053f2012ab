"""Sphere-impostor renderer — the counterpart of sph_tpu.render.impostor:
radius-scaled, orientation-shaded spheres with the reference's lighting
model (InstancedParticles.shader:118-177):

    diffuse  = cellColor · saturate(N·L) · lightColor        (:164)
    ambient  = cellColor · 0.3                                (:165)
    specular = saturate(N·H)^32 · 0.5 · lightColor · 0.5      (:166)
    redDot   = (1,0,0) · smoothstep(0.98, 1, N·F)             (:171-175)
    final    = diffuse + ambient + specular + redDot          (:177)

where F is the particle's body +Z axis in world space (the reference's
visual orientation indicator) and N the sphere surface normal.

Each particle emits a fixed WINDOW×WINDOW block of screen samples around
its projected centre; each sample ray-traces its own sphere point (disc
test, normal, front-surface depth). Occlusion is a two-pass z-buffer: a
per-pixel minimum of sample depths, then a winner test per sample. The
winners' shades are averaged per pixel with the sums in sample order (a
stable sort by pixel, then a segmented sum), so the card repeats a frame
bit for bit.

For the cell sim's scale: samples = N·WINDOW², so each [N, 24, 24, 3] f32
temporary is 71 MB at 10,240 cells and 6.9 GB at 1M. The fluid path keeps
the additive splats (render/splat.py).
"""

from __future__ import annotations

import torch

from sph_tpu_torch.render.splat import (
    camera_tensors,
    dot3,
    fma,
    project_points,
    segment_sums,
)


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b as XLA fuses jnp.cross on the CPU: each component's first
    product fused into the subtraction of the second."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([fma(a1, b2, -(a2 * b1)), fma(a2, b0, -(a0 * b2)),
                        fma(a0, b1, -(a1 * b0))], dim=-1)


def _forward_axes(rot: torch.Tensor) -> torch.Tensor:
    """Unit body +Z axes in world space: quat.rotate(rot, ẑ) normalised,
    formed as the JAX package forms them (its cross products and norm are
    fused), since the red dot's smoothstep multiplies their rounding by
    up to 75."""
    ez = torch.zeros_like(rot[:, :3])
    ez[:, 2] = 1.0
    u, w = rot[:, :3], rot[:, 3:4]
    f = ez + 2.0 * _cross(u, _cross(u, ez) + w * ez)
    return f / torch.clamp_min(torch.sqrt(dot3(f, f))[:, None], 1e-9)


def _unit(v: torch.Tensor) -> torch.Tensor:
    """v / |v| for a 3-vector, its squares added in order (on the host, so
    both devices get the same bits)."""
    v = v.to(device="cpu", dtype=torch.float32)
    return v / torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def render_spheres(
    pos: torch.Tensor,
    radius: torch.Tensor,
    rot: torch.Tensor,
    colors: torch.Tensor,
    camera_params,
    width: int = 640,
    height: int = 360,
    mask: torch.Tensor | None = None,
    window: int = 24,
    light_dir=(0.4, 0.8, -0.45),
    light_color=(1.0, 1.0, 1.0),
    show_dot: bool = True,
    background=(0.02, 0.02, 0.05),
) -> torch.Tensor:
    """Shaded sphere-impostor image [H, W, 3] in [0, 1], on pos's device.

    pos [N,3], radius [N], rot [N,4] quaternions, colors [N,3] (per-mode
    cell colors). window: per-particle sample block edge in pixels; spheres
    whose projected diameter exceeds it are clipped to the window (pick a
    camera distance accordingly)."""
    dev = pos.device
    eye, right, up, forward, tanf = camera_tensors(camera_params, dev)

    px, py, z, visible = project_points(pos, eye, right, up, forward, tanf,
                                        width, height)
    if mask is not None:
        visible = visible & mask

    # Projected pixel radius: world radius / (z·tan_half_fov) in NDC, times
    # half the screen height (the shader scales mesh verts by p.radius —
    # shader:97 — this is the impostor equivalent).
    r_px = radius * (height * 0.5) / (torch.clamp_min(z, 1e-6) * tanf)
    r_px = torch.clamp(r_px, 0.5, window * 0.5)

    half = window // 2
    duv = torch.arange(window, dtype=torch.float32, device=dev) - (half - 0.5)
    du = duv[None, :, None]                       # [1, W, 1] x-offsets
    dv = duv[None, None, :]                       # [1, 1, W] y-offsets
    cx = torch.floor(px)[:, None, None]
    cy = torch.floor(py)[:, None, None]
    sx = cx + du                                  # sample pixel coords
    sy = cy + dv
    ox = (sx - px[:, None, None]) / r_px[:, None, None]
    oy = (sy - py[:, None, None]) / r_px[:, None, None]
    d2 = ox * ox + oy * oy
    inside = (d2 <= 1.0) & visible[:, None, None]
    in_frame = (sx >= 0) & (sx < width) & (sy >= 0) & (sy < height)
    inside = inside & in_frame

    nz = torch.sqrt(torch.clamp_min(1.0 - d2, 0.0))
    # Camera-space sphere normal at the sample, world-space via the camera
    # basis (screen y grows downward ⇒ −up; the visible surface faces the
    # camera ⇒ −forward).
    n_world = (ox[..., None] * right - oy[..., None] * up
               - nz[..., None] * forward)
    # Front sphere surface depth.
    depth = z[:, None, None] - nz * radius[:, None, None]

    npix = width * height
    pid = torch.where(
        inside, sy.to(torch.int32) * width + sx.to(torch.int32), npix).long()

    # Pass 1: z-buffer (a minimum: no order of the samples changes it).
    zed = torch.where(inside, depth, float("inf"))
    zb = torch.full((npix + 1,), float("inf"), dtype=torch.float32,
                    device=dev)
    zb.scatter_reduce_(0, pid.reshape(-1), zed.reshape(-1), "amin")
    zb = zb[:npix]

    # Pass 2: shade winners (samples whose depth matches the z-buffer).
    win = inside & (depth <= zb[torch.clamp(pid, 0, npix - 1)]
                    * (1.0 + 1e-6) + 1e-7)

    ldir = _unit(torch.tensor(light_dir))
    view = -forward.cpu()                            # orthographic-ish view
    h_vec = _unit(ldir + view).to(dev)
    ldir = ldir.to(dev)
    lcol = torch.tensor(light_color, dtype=torch.float32, device=dev)
    ndotl = torch.clamp(dot3(n_world, ldir), 0.0, 1.0)
    ndoth = torch.clamp(dot3(n_world, h_vec), 0.0, 1.0)

    cell = colors[:, None, None, :]
    diffuse = cell * ndotl[..., None] * lcol
    ambient = cell * 0.3
    specular = (ndoth ** 32.0)[..., None] * 0.5 * lcol * 0.5
    shade = diffuse + ambient + specular

    if show_dot:
        ndotf = dot3(n_world, _forward_axes(rot)[:, None, None, :])
        red = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=dev)
        shade = shade + red * _smoothstep(0.98, 1.0, ndotf)[..., None]

    # Per-pixel mean of the winners' shades (a losing sample adds +0 to
    # the sum in the JAX package; here it is left out, which is the same).
    flat_win = win.reshape(-1)
    flat_pid = pid.reshape(-1)
    num = segment_sums(shade.reshape(-1, 3), flat_pid, flat_win, npix)
    den = torch.bincount(flat_pid[flat_win], minlength=npix)[:npix]
    den = den.to(torch.float32)
    img = num / torch.clamp_min(den, 1.0)[:, None]
    covered = (den > 0.0)[:, None]
    bg = torch.tensor(background, dtype=torch.float32, device=dev)
    img = torch.where(covered, img, bg)
    return torch.clamp(img.view(height, width, 3), 0.0, 1.0)
