"""Interactive viewer loop (L5) — the counterpart of sph_tpu.app.viewer,
the reference's live app loop (ParticleSystemController.Update + CameraFly
+ mouse drag, ParticleSystemController.cs:244-351, :975-1034;
CameraFly.cs): per displayed frame the sim advances `substeps` physics
steps (`Simulation.step(substeps)`, a host loop of launches), the sphere
impostors are rendered on the device, and the host reads back the
[H, W, 3] image's bytes and the overlay's inputs (the bond table for the
bond lines). Drag input travels to the device as the tiny DragInput
tensors (the reference syncs the whole buffer every frame, cs:332-333).

Event model (front-end agnostic — scripted files, tests, or the ANSI tty
front-end all feed the same dicts):

    {"type": "mouse_down", "x": px, "y": py}   pick + begin drag (cs:975)
    {"type": "mouse_move", "x": px, "y": py}   update drag target (cs:1016)
    {"type": "mouse_up"}                       release (cs:1027-1034)
    {"type": "key", "key": "w|a|s|d|q|e", "sprint": bool}  camera fly
    {"type": "look", "dx": deg, "dy": deg}     RMB mouse-look
    {"type": "scroll", "amount": s}            zoom
    {"type": "orbit"}                          'O' toggle (CameraFly.cs:140)
    {"type": "focus", "slot": i}               FocusOnCell (CameraFly.cs:156)

Drag semantics mirror the reference exactly: on press, a pixel ray picks the
nearest sphere (max_radius pick radius, cs:977-1013); while held, the target
sits on the current pixel ray AT THE PICK'S CAMERA DISTANCE (cs:1016-1020)
with strength 100 (cs:1027-1032); release clears the force.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from sph_tpu_torch.render.camera import Camera
from sph_tpu_torch.render.overlay import render_cells_frame


class ViewerLoop:
    """Drives a Simulation at interactive rates with live drag/camera input.

    >>> v = ViewerLoop(sim)
    >>> v.frame([{"type": "mouse_down", "x": 400, "y": 225}])
    >>> v.frame([{"type": "mouse_move", "x": 500, "y": 225}])
    >>> v.frame([{"type": "mouse_up"}])
    """

    def __init__(self, sim, width: int = 800, height: int = 450,
                 substeps: int = 4, camera: Camera | None = None,
                 show_labels: bool = False, show_bonds: bool = True):
        self.sim = sim
        self.width = width
        self.height = height
        self.substeps = substeps
        self.show_labels = show_labels
        self.show_bonds = show_bonds
        if camera is None:
            camera = Camera()
            camera.focus_on((0, 0, 0), distance=3.0 * sim.params.spawn_radius)
        self.camera = camera
        self.drag_slot = -1
        self.drag_distance = 0.0     # fixed camera distance (cs:1016-1020)
        self.frame_count = 0
        self.fps = float("nan")      # sim+render+readback, measured
        self._frame_times: list[float] = []

    # -- input ---------------------------------------------------------------

    def handle_event(self, ev: dict) -> None:
        t = ev.get("type")
        if t == "mouse_down":
            origin, d = self.camera.pixel_ray(
                ev["x"], ev["y"], self.width, self.height
            )
            slot = self.sim.pick(origin, d)
            self.drag_slot = slot
            if slot >= 0:
                hit = self.sim.state.pos[slot].cpu().numpy()
                self.drag_distance = float(np.dot(hit - origin, d))
                self.sim.set_drag(slot, origin + d * self.drag_distance,
                                  strength=100.0)
        elif t == "mouse_move":
            if self.drag_slot >= 0:
                origin, d = self.camera.pixel_ray(
                    ev["x"], ev["y"], self.width, self.height
                )
                self.sim.set_drag(
                    self.drag_slot, origin + d * self.drag_distance,
                    strength=100.0,
                )
        elif t == "mouse_up":
            self.drag_slot = -1
            self.sim.clear_drag()
        elif t == "key":
            k = ev.get("key", "")
            dt = ev.get("dt", 1.0 / 30.0)
            axes = {"w": (1, 0, 0), "s": (-1, 0, 0), "a": (0, -1, 0),
                    "d": (0, 1, 0), "e": (0, 0, 1), "q": (0, 0, -1)}
            if k in axes:
                f, s, l = axes[k]
                self.camera.move(dt, forward=f, strafe=s, lift=l,
                                 sprint=bool(ev.get("sprint")))
        elif t == "look":
            self.camera.look(ev.get("dx", 0.0), ev.get("dy", 0.0))
        elif t == "scroll":
            self.camera.zoom(ev.get("amount", 0.0))
        elif t == "orbit":
            self.camera.toggle_orbit()
        elif t == "focus":
            slot = int(ev.get("slot", 0))
            if 0 <= slot < int(self.sim.state.active_count):
                self.camera.focus_on(
                    self.sim.state.pos[slot].cpu().numpy(),
                    distance=3.0 * self.sim.params.spawn_radius,
                )

    # -- frame ---------------------------------------------------------------

    def frame(self, events=()):
        """Process events, advance `substeps` physics steps, render. Returns
        the frame (render.image.Frame: np.asarray for pixels, .save for a
        PNG)."""
        t0 = time.perf_counter()
        for ev in events:
            self.handle_event(ev)
        if self.camera.orbit_mode:
            self.camera.orbit(1.0 / 30.0)
        self.sim.step(self.substeps)
        frame = render_cells_frame(
            self.sim, camera=self.camera, width=self.width,
            height=self.height, show_labels=self.show_labels,
            show_bonds=self.show_bonds,
        )
        dt = time.perf_counter() - t0
        self._frame_times.append(dt)
        if len(self._frame_times) > 30:
            self._frame_times.pop(0)
        self.fps = 1.0 / max(float(np.mean(self._frame_times)), 1e-9)
        self.frame_count += 1
        return frame

    def run(self, n_frames: int, script=None, out_dir: str | None = None,
            tty: bool = False, watcher=None):
        """Run the loop headless. `script` maps frame index -> event list
        (dict with int or str keys, or a list indexed by frame).
        `watcher` (engine.config.SceneWatcher) is polled once per frame —
        the reference's editor OnValidate → OnGenomeChanged tick
        (CellGenome.cs:90-105) at frame granularity."""
        stats = []
        for i in range(n_frames):
            if watcher is not None:
                watcher.poll()
            events = []
            if script is not None:
                if isinstance(script, dict):
                    events = script.get(i, script.get(str(i), []))
                elif i < len(script):
                    events = script[i]
            frame = self.frame(events)
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                frame.save(os.path.join(out_dir, f"view_{i:05d}.png"))
            if tty:
                _blit_ansi(np.asarray(frame), self.fps)
            stats.append({
                "frame": i, "fps": round(self.fps, 1),
                "active": int(self.sim.state.active_count),
                "drag_slot": self.drag_slot,
            })
        return stats


def _blit_ansi(arr: np.ndarray, fps: float, cols: int = 100) -> None:
    """Terminal front-end: draw the frame as ANSI truecolor half-blocks
    (two pixels per character row, '▀' fg=upper bg=lower)."""
    h, w = arr.shape[:2]
    step = max(1, w // cols)
    small = arr[::step * 2, ::step]          # rows advance 2 px per char
    lower = arr[step::step * 2, ::step]
    n = min(small.shape[0], lower.shape[0])
    out = ["\x1b[H"]
    for r in range(n):
        row = []
        for c in range(small.shape[1]):
            tr, tg, tb = small[r, c][:3]
            br, bg_, bb = lower[r, c][:3]
            row.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg_};{bb}m▀"
            )
        out.append("".join(row) + "\x1b[0m")
    out.append(f"\x1b[0m fps: {fps:5.1f}   (ctrl-c quits)")
    sys.stdout.write("\n".join(out) + "\n")
    sys.stdout.flush()


def load_script(path: str):
    """Event script JSON: {"<frame>": [events...]} or [[events...], ...]."""
    with open(path) as f:
        return json.load(f)
