"""Quaternion library, [x, y, z, w] layout, batched over leading axes — the
counterpart of sph_tpu.core.quat.

Conventions as the reference's (SimulateParticles.compute:359-377; Unity
Euler z-x-y with roll 0 and Quaternion.LookRotation as the division engine
uses them, ParticleSystemController.cs:748-969). Every function is written
operation for operation as the JAX version, so on the same inputs the two
differ only where a backend contracts a multiply-add or sums in another
order.
"""

from __future__ import annotations

import torch


def identity(shape=(), device="cuda") -> torch.Tensor:
    """Identity quaternion(s) [0, 0, 0, 1] with the given batch shape."""
    q = torch.zeros((*shape, 4), dtype=torch.float32, device=device)
    q[..., 3] = 1.0
    return q


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis, broadcasting like jnp.cross."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis, as jnp.linalg.norm forms it."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2 (quat_mul, compute:359-365)."""
    v1, w1 = q1[..., :3], q1[..., 3:4]
    v2, w2 = q2[..., :3], q2[..., 3:4]
    v = w1 * v2 + w2 * v1 + cross(v1, v2)
    w = w1 * w2 - dot(v1, v2, keepdim=True)
    return torch.cat([v, w], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (the inverse of a unit quaternion; compute:367-371)."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q (compute:373-377)."""
    u = q[..., :3]
    w = q[..., 3:4]
    return v + 2.0 * cross(u, cross(u, v) + w * v)


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = norm(q, keepdim=True)
    return q / torch.clamp(n, min=eps)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit quaternion from a (normalised) axis and an angle."""
    angle = angle[..., None]
    s = torch.sin(angle * 0.5)
    c = torch.cos(angle * 0.5)
    return torch.cat([axis * s, c], dim=-1)


def euler_direction(yaw_deg: torch.Tensor,
                    pitch_deg: torch.Tensor) -> torch.Tensor:
    """Unity `Quaternion.Euler(pitch, yaw, 0) * Vector3.forward`:
    (sin yaw·cos pitch, −sin pitch, cos yaw·cos pitch) (GetDirection,
    ParticleSystemController.cs:966-969)."""
    yaw = torch.deg2rad(yaw_deg.to(torch.float32))
    pitch = torch.deg2rad(pitch_deg.to(torch.float32))
    cp = torch.cos(pitch)
    return torch.stack(
        [torch.sin(yaw) * cp, -torch.sin(pitch), torch.cos(yaw) * cp],
        dim=-1)


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (…, 3, 3; column vectors) → quaternion [x, y, z, w]:
    all four Shepperd candidates, selected by the largest pivot."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    t0 = 1.0 + tr
    q0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, t0], dim=-1)
    t1 = 1.0 + m00 - m11 - m22
    q1 = torch.stack([t1, m01 + m10, m02 + m20, m21 - m12], dim=-1)
    t2 = 1.0 - m00 + m11 - m22
    q2 = torch.stack([m01 + m10, t2, m12 + m21, m02 - m20], dim=-1)
    t3 = 1.0 - m00 - m11 + m22
    q3 = torch.stack([m02 + m20, m12 + m21, t3, m10 - m01], dim=-1)

    ts = torch.stack([t0, t1, t2, t3], dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    idx = torch.argmax(ts, dim=-1)    # first maximum, as jnp.argmax
    q = torch.take_along_dim(qs, idx[..., None, None].expand(
        *idx.shape, 1, 4), dim=-2).squeeze(-2)
    return normalize(q)


def look_rotation(forward: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Unity `Quaternion.LookRotation(forward, up)`: z = f̂,
    x = normalize(up × f̂), y = z × x (cs:757, :760)."""
    z = forward / torch.clamp(norm(forward, keepdim=True), min=1e-12)
    x = cross(up, z)
    x = x / torch.clamp(norm(x, keepdim=True), min=1e-12)
    y = cross(z, x)
    return from_matrix(torch.stack([x, y, z], dim=-1))


def _basis(i: int, like: torch.Tensor) -> torch.Tensor:
    # Filled on the device: a tensor made from a Python list would be a
    # host-to-device copy that waits for the stream.
    e = torch.zeros(3, dtype=torch.float32, device=like.device)
    e[i] = 1.0
    return e


def axis3(q: torch.Tensor):
    """Body frame axes (right, up, forward) = q·(x̂, ŷ, ẑ)."""
    return tuple(rotate(q, _basis(i, q)) for i in range(3))


def integrate_angular(q: torch.Tensor, omega: torch.Tensor, dt,
                      angle_eps: float = 1e-5) -> torch.Tensor:
    """Axis-angle quaternion integration (UpdateRotation, compute:394-404):
    dq = (axis·sin(θ/2), cos(θ/2)), θ = |ω·dt|, skipped below angle_eps."""
    w_dt = omega * dt
    angle = norm(w_dt, keepdim=True)
    axis = w_dt / torch.clamp(angle, min=1e-20)
    s = torch.sin(angle * 0.5)
    c = torch.cos(angle * 0.5)
    dq = torch.cat([axis * s, c], dim=-1)
    q_new = normalize(mul(dq, q))
    return torch.where(angle > angle_eps, q_new, q)
