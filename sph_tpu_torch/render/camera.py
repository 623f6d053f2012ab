"""Host-side camera with the reference's control semantics
(Assets/Scripts/CameraFly.cs): free-fly WASD/QE with sprint, mouse-look with
±80° pitch clamp (:102-117), scroll zoom (:119-128), orbit mode around a
target (:130-146), and focus_on_cell (:156-170). Produces the view/projection
transform consumed by the on-device rasterizer.

Host numpy only: a copy of sph_tpu.render.camera, kept here so the port
imports nothing of the JAX package. It runs the same numpy operations, so
the two cameras agree bit for bit (tests/test_torch_render.py)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Camera:
    position: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, -40.0], np.float32)
    )
    yaw: float = 0.0            # degrees
    pitch: float = 0.0          # degrees, clamped ±80 (CameraFly.cs:110)
    fov_deg: float = 60.0
    move_speed: float = 10.0    # CameraFly.cs:25
    sprint_multiplier: float = 3.0
    look_sensitivity: float = 2.0
    zoom_speed: float = 10.0
    orbit_mode: bool = False
    orbit_target: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    orbit_distance: float = 40.0

    # -- orientation ---------------------------------------------------------

    def basis(self):
        """(right, up, forward) from yaw/pitch (y-up, z-forward at rest)."""
        cy, sy = np.cos(np.deg2rad(self.yaw)), np.sin(np.deg2rad(self.yaw))
        cp, sp = np.cos(np.deg2rad(self.pitch)), np.sin(np.deg2rad(self.pitch))
        forward = np.array([sy * cp, -sp, cy * cp], np.float32)
        right = np.array([cy, 0.0, -sy], np.float32)
        up = np.cross(forward, right)
        return right, up / max(np.linalg.norm(up), 1e-9), forward

    # -- controls (CameraFly.cs semantics) -----------------------------------

    def look(self, dx: float, dy: float) -> None:
        """Mouse-look: yaw += dx, pitch += dy, pitch clamped ±80°."""
        self.yaw += dx * self.look_sensitivity
        self.pitch = float(
            np.clip(self.pitch + dy * self.look_sensitivity, -80.0, 80.0)
        )

    def move(self, dt: float, forward=0.0, strafe=0.0, lift=0.0,
             sprint=False) -> None:
        """WASD + QE free fly (CameraFly.cs:87-100)."""
        r, u, f = self.basis()
        speed = self.move_speed * (self.sprint_multiplier if sprint else 1.0)
        self.position = (
            self.position + (f * forward + r * strafe + u * lift) * speed * dt
        ).astype(np.float32)

    def zoom(self, scroll: float) -> None:
        """Scroll zoom along the view direction (CameraFly.cs:119-128)."""
        _, _, f = self.basis()
        if self.orbit_mode:
            self.orbit_distance = max(1.0, self.orbit_distance - scroll)
        else:
            self.position = (
                self.position + f * scroll * self.zoom_speed
            ).astype(np.float32)

    def toggle_orbit(self, target=None) -> None:
        """'O' toggle (CameraFly.cs:140-146)."""
        self.orbit_mode = not self.orbit_mode
        if target is not None:
            self.orbit_target = np.asarray(target, np.float32)
        if self.orbit_mode:
            self.orbit_distance = float(
                np.linalg.norm(self.position - self.orbit_target)
            )

    def orbit(self, dt: float, speed_deg: float = 30.0) -> None:
        if not self.orbit_mode:
            return
        self.yaw += speed_deg * dt
        self._apply_orbit()

    def _apply_orbit(self) -> None:
        _, _, f = self.basis()
        self.position = (
            self.orbit_target - f * self.orbit_distance
        ).astype(np.float32)

    def focus_on(self, target, distance: float = 10.0) -> None:
        """FocusOnCell parity (CameraFly.cs:156-170): place the camera at a
        distance, looking at the target."""
        target = np.asarray(target, np.float32)
        d = target - self.position
        n = np.linalg.norm(d)
        if n > 1e-6:
            d = d / n
            self.yaw = float(np.rad2deg(np.arctan2(d[0], d[2])))
            self.pitch = float(np.clip(np.rad2deg(-np.arcsin(d[1])), -80, 80))
        self.position = (target - d * distance).astype(np.float32)
        self.orbit_target = target

    def pixel_ray(self, x: float, y: float, width: int, height: int):
        """(origin, dir) of the world ray through pixel (x, y) — the inverse
        of splat.project_points; used for mouse picking
        (ParticleSystemController.cs:977-1013 casts the same camera ray)."""
        r, u, f = self.basis()
        tanf = float(np.tan(np.deg2rad(self.fov_deg) * 0.5))
        aspect = width / height
        ndc_x = (x / max(width - 1, 1) - 0.5) * 2.0
        ndc_y = (1.0 - y / max(height - 1, 1) - 0.5) * 2.0
        d = r * (ndc_x * tanf * aspect) + u * (ndc_y * tanf) + f
        d = d / max(np.linalg.norm(d), 1e-12)
        return self.position.copy(), d.astype(np.float32)

    # -- transform for the rasterizer ----------------------------------------

    def view_params(self):
        """(eye[3], right[3], up[3], forward[3], tan_half_fov) as float32."""
        r, u, f = self.basis()
        tanf = float(np.tan(np.deg2rad(self.fov_deg) * 0.5))
        return (
            self.position.astype(np.float32), r.astype(np.float32),
            u.astype(np.float32), f.astype(np.float32), tanf,
        )
