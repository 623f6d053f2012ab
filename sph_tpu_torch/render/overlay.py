"""Host-side debug overlays on rendered frames — the counterpart of
sph_tpu.render.overlay, the reference's L4 visualization channels (SURVEY
§2.10): per-particle ID labels (TMP labels, ParticleSystemController.cs:
1292-1350), zone-colored bond lines with the white anchor-to-anchor line
(CellAdhesionManager.cs:245-304), yellow anchor gizmo markers (CAM:564-590),
drag circle + particle-to-target line (cs:1036-1063), and the selected
cell's split-plane ring (cs:1065-1109).

Where the JAX package draws each primitive with PIL as it goes, the port
first builds the frame's whole list of draw commands (`overlay_commands`:
line, ellipse and text, each with its points, colour and width, in the
order the JAX package draws them), then rasterises the list at once
(render/raster.py). The commands are built from arrays, not per bond; the
per-bond dicts of `Simulation.bond_lines` are read as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from sph_tpu_torch.render.image import Frame, frame_bytes
from sph_tpu_torch.render.raster import (
    ELLIPSE,
    LINE,
    TEXT,
    DrawList,
    rasterize,
)

WHITE, YELLOW, CYAN = (255, 255, 255), (255, 255, 0), (0, 255, 255)
GREEN, LABEL = (0, 255, 0), (255, 255, 160)


def _project(points, camera, width, height):
    """Host-side projection matching render.splat.project_points."""
    eye, right, up, fwd, tanf = camera.view_params()
    rel = np.asarray(points, np.float32) - eye
    x = rel @ right
    y = rel @ up
    z = rel @ fwd
    safe = np.maximum(z, 1e-6)
    aspect = width / height
    px = (x / (safe * tanf * aspect) * 0.5 + 0.5) * (width - 1)
    py = (1.0 - (y / (safe * tanf) * 0.5 + 0.5)) * (height - 1)
    vis = (z > 1e-3) & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    return px, py, vis


def split_plane_ring_points(center, rot, split_yaw, split_pitch,
                            radius: float = 2.0, segments: int = 48):
    """World-space ring showing a cell's division plane
    (UpdateSplitPlaneRings, ParticleSystemController.cs:1065-1109): normal =
    the mode's split direction through the cell's rotated frame; the ring is
    the radius-2 circle in the plane ⊥ normal, 48 segments (+1 closing
    point), matching the reference's defaults (cs:51-52)."""
    from sph_tpu_torch.core import quat

    d_local = quat.euler_direction(
        torch.tensor(np.float32(split_yaw)),
        torch.tensor(np.float32(split_pitch))).numpy()
    r3 = quat.rotate(torch.as_tensor(np.asarray(rot, np.float32))[None, :],
                     torch.eye(3, dtype=torch.float32)).numpy()
    # rows of r3: world images of local x/y/z axes.
    normal = (r3[0] * d_local[0] + r3[1] * d_local[1] + r3[2] * d_local[2])
    normal = normal / max(np.linalg.norm(normal), 1e-12)
    # Quaternion.FromToRotation(up, normal) applied to circle points in the
    # local XZ plane == any orthonormal basis (u, v) of the plane ⊥ normal.
    ref = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(normal @ ref)) > 0.99:
        ref = np.array([1.0, 0.0, 0.0], np.float32)
    u = np.cross(ref, normal)
    u = u / max(np.linalg.norm(u), 1e-12)
    v = np.cross(normal, u)
    ang = np.linspace(0.0, 2.0 * np.pi, segments + 1)
    return (
        np.asarray(center, np.float32)[None, :]
        + radius * (np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * v)
    ).astype(np.float32)


def _bond_commands(bond_lines, camera, w, h, show_anchors) -> DrawList:
    """Per bond, in order: its two zone-coloured halves (width 2) if both
    ends and the midpoint are in view; the white anchor-to-anchor line and,
    with show_anchors, a yellow circle on each anchor if both anchors
    are."""
    # ONE batched projection of all bonds' 5 points.
    all_pts = np.array(
        [[b["a"], b["midpoint"], b["b"], b["anchor_a"], b["anchor_b"]]
         for b in bond_lines], np.float32
    ).reshape(-1, 3)
    apx, apy, avis = _project(all_pts, camera, w, h)
    px, py, vis = apx.reshape(-1, 5), apy.reshape(-1, 5), avis.reshape(-1, 5)
    nb = len(px)
    ca = (np.array([b["color_a"] for b in bond_lines], np.float64)
          * 255).astype(np.int64)
    cb = (np.array([b["color_b"] for b in bond_lines], np.float64)
          * 255).astype(np.int64)

    def seg(i, j):
        return np.stack([px[:, i], py[:, i], px[:, j], py[:, j]], axis=1)

    def ring(k):
        return np.stack([px[:, k] - 3, py[:, k] - 3, px[:, k] + 3,
                         py[:, k] + 3], axis=1)

    halves = vis[:, :3].all(axis=1)
    anchors = vis[:, 3:].all(axis=1)
    # Five command slots a bond, taken where drawn, bond by bond.
    slots = [
        (LINE, seg(0, 1), ca, 2, halves),
        (LINE, seg(1, 2), cb, 2, halves),
        (LINE, seg(3, 4), np.broadcast_to(WHITE, (nb, 3)), 1, anchors),
        (ELLIPSE, ring(3), np.broadcast_to(YELLOW, (nb, 3)), 1,
         anchors & show_anchors),
        (ELLIPSE, ring(4), np.broadcast_to(YELLOW, (nb, 3)), 1,
         anchors & show_anchors),
    ]
    drawn = np.stack([s[4] for s in slots], axis=1).reshape(-1)
    return DrawList(
        kind=np.tile(np.array([s[0] for s in slots], np.int8), nb)[drawn],
        xy=np.stack([s[1] for s in slots], 1).reshape(-1, 4)[drawn],
        fill=np.stack([s[2] for s in slots], 1).reshape(-1, 3)[drawn]
        .astype(np.uint8),
        width=np.tile(np.array([s[3] for s in slots], np.int32), nb)[drawn],
        text=[""] * int(drawn.sum()))


def overlay_commands(
    camera,
    width: int,
    height: int,
    labels: list[tuple] | None = None,        # [(pos3, text)]
    bond_lines: list[dict] | None = None,      # Simulation.bond_lines()
    drag_target=None,                          # world pos or None
    drag_from=None,                            # dragged particle pos or None
    split_ring=None,                           # [S+1, 3] world points or None
    show_anchors: bool = False,                # yellow gizmos (CAM:564-590)
) -> DrawList:
    """The overlay's draw commands for a width × height frame, in the JAX
    package's drawing order: bonds, the split-plane ring, labels, drag."""
    w, h = width, height
    cmds = DrawList()
    if bond_lines:
        cmds = cmds + _bond_commands(bond_lines, camera, w, h, show_anchors)

    if split_ring is not None:
        # Cyan split-plane ring of the selected cell (cs:1065-1109).
        px, py, vis = _project(np.asarray(split_ring, np.float32),
                               camera, w, h)
        both = vis[:-1] & vis[1:]
        xy = np.stack([px[:-1], py[:-1], px[1:], py[1:]], axis=1)[both]
        cmds = cmds + DrawList.of(LINE, xy, CYAN, 1)

    if labels:
        pts = np.array([p for p, _ in labels], np.float32)
        px, py, vis = _project(pts, camera, w, h)
        keep = np.nonzero(vis & np.isfinite(px) & np.isfinite(py))[0]
        xy = np.stack([px[keep] + 3, py[keep] - 8, np.zeros(len(keep)),
                       np.zeros(len(keep))], axis=1)
        cmds = cmds + DrawList.of(TEXT, xy, LABEL, 0,
                                  [labels[i][1] for i in keep])

    if drag_target is not None:
        ends = [np.asarray(drag_target, np.float32)]
        if drag_from is not None:
            ends.append(np.asarray(drag_from, np.float32))
        px, py, vis = _project(np.asarray(ends, np.float32), camera, w, h)
        if vis[0]:
            r = 6
            # Green drag circle (cs:1036-1063).
            cmds = cmds + DrawList.of(
                ELLIPSE, [px[0] - r, py[0] - r, px[0] + r, py[0] + r],
                GREEN, 2)
        if drag_from is not None and vis.all():
            # Particle-to-target drag line (cs:1054-1056).
            cmds = cmds + DrawList.of(LINE, [px[1], py[1], px[0], py[0]],
                                      GREEN, 1)
    return cmds


def draw_overlays(img, camera, labels=None, bond_lines=None,
                  drag_target=None, drag_from=None, split_ring=None,
                  show_anchors: bool = False) -> Frame:
    """Return a Frame of `img` ([H,W,3] float 0..1, on any device) with
    overlays: one readback of the image's bytes, then the commands."""
    arr = frame_bytes(img)
    h, w = arr.shape[:2]
    cmds = overlay_commands(camera, w, h, labels=labels,
                            bond_lines=bond_lines, drag_target=drag_target,
                            drag_from=drag_from, split_ring=split_ring,
                            show_anchors=show_anchors)
    return Frame(rasterize(arr, cmds))


def default_camera(sim):
    from sph_tpu_torch.render.camera import Camera

    camera = Camera()
    camera.focus_on((0, 0, 0), distance=3.0 * sim.params.spawn_radius)
    return camera


def cells_image(sim, camera, width=800, height=450, impostor=True):
    """The colony's on-device image [H, W, 3]: sphere impostors coloured by
    mode, or (impostor=False) the cheaper additive splats."""
    from sph_tpu_torch.render.impostor import render_spheres
    from sph_tpu_torch.render.splat import render_points

    st = sim.state
    n_modes = max(len(sim.genome.modes), 1)
    colors = sim.genome_dev.mode_color[:, :3][
        torch.clamp(st.mode, 0, n_modes - 1).long()]
    mask = (torch.arange(st.capacity, device=st.pos.device)
            < st.active_count)
    if impostor:
        return render_spheres(st.pos, st.radius, st.rot, colors,
                              camera.view_params(), width=width,
                              height=height, mask=mask)
    return render_points(st.pos, camera.view_params(), width=width,
                         height=height, colors=colors, mask=mask,
                         splat_radius_px=4)


def overlay_inputs(sim, show_labels=True, show_bonds=True,
                   show_split_rings=False) -> dict:
    """What the overlays draw, read from the sim on the host: labels, bond
    lines, the drag target and dragged cell, the selected cell's ring."""
    st = sim.state
    n = int(st.active_count)
    labels = None
    if show_labels:
        pos = st.pos[:n].cpu().numpy()
        ids = sim.particle_ids()
        labels = [(pos[i], ids[i]) for i in range(n)]
    bonds = sim.bond_lines() if show_bonds else None
    drag = drag_from = None
    sel = int(st.drag_input.selected_slot)
    if sel >= 0:
        drag = st.drag_input.target.cpu().numpy()
        if sel < n:
            drag_from = st.pos[sel].cpu().numpy()
    ring = None
    last = getattr(sim, "last_selected", -1)
    n_modes = max(len(sim.genome.modes), 1)
    if show_split_rings and 0 <= last < n:
        mode = int(st.mode[last])
        if 0 <= mode < n_modes:
            m = sim.genome.modes[mode]
            ring = split_plane_ring_points(
                st.pos[last].cpu().numpy(), st.rot[last].cpu().numpy(),
                m.parent_split_yaw, m.parent_split_pitch,
            )
    return dict(labels=labels, bond_lines=bonds, drag_target=drag,
                drag_from=drag_from, split_ring=ring)


def render_cells_frame(sim, camera=None, width=800, height=450,
                       show_labels=True, show_bonds=True, path=None,
                       impostor=True, show_anchors=True,
                       show_split_rings=False) -> Frame:
    """Full cell-sim frame: on-device spheres + host overlays (ids, bonds,
    anchor gizmos, drag circle+line, selected cell's split-plane ring) —
    the reference's complete visual channel set. show_anchors defaults on
    and show_split_rings off, matching the shipped scene
    (CellAdhesionManager.cs:14, Particle Simulation.unity
    showSplitPlaneRings 0).

    impostor=True renders radius-scaled, orientation-shaded sphere impostors
    with the red forward-axis dot (InstancedParticles.shader:84-116,
    146-177); False falls back to the cheaper additive splats."""
    if camera is None:
        camera = default_camera(sim)
    img = cells_image(sim, camera, width, height, impostor)
    frame = draw_overlays(
        img, camera, show_anchors=show_anchors,
        **overlay_inputs(sim, show_labels, show_bonds, show_split_rings))
    if path:
        frame.save(path)
    return frame
