"""Plain PyTorch reference of one frame of the bonded colony on a full
population (no division can happen): soft-sphere contact with rolling
friction, then the adhesion constraints (distance spring, anchor swing,
relative orientation), exponential damping with the spherical boundary,
and the axis-angle rotation update; the bond table does not change.

Written from the semantics of sph_tpu_torch/physics/contact.py,
physics/adhesion.py, physics/integrate.py and core/quat.py at commit
5740b39 (the reference's ApplySPHForces, ApplyAdhesionConstraints,
UpdateMotion and UpdateRotation), on flat arrays with a cell-list contact
search (reference/grid.py) and scatter-add sums: no dense layout, no bond
plan, no sort order. Runs in any dtype (float32 is the configuration's;
bfloat16 is its control).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.grid import pairs_within


def cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def dot(a, b, keepdim=False):
    return (a * b).sum(-1, keepdim=keepdim)


def norm(x, keepdim=False):
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def qmul(q1, q2):
    v1, w1 = q1[..., :3], q1[..., 3:4]
    v2, w2 = q2[..., :3], q2[..., 3:4]
    return torch.cat([w1 * v2 + w2 * v1 + cross(v1, v2),
                      w1 * w2 - dot(v1, v2, keepdim=True)], -1)


def qconj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], -1)


def qrotate(q, v):
    u, w = q[..., :3], q[..., 3:4]
    return v + 2.0 * cross(u, cross(u, v) + w * v)


def qnormalize(q):
    return q / torch.clamp(norm(q, keepdim=True), min=1e-12)


def qaxis_angle(axis, angle):
    a = angle[..., None] * 0.5
    return torch.cat([axis * torch.sin(a), torch.cos(a)], -1)


def contact(pos, vel, om, radius, p: dict):
    """(force, torque) per cell summed over the cells in contact."""
    i, j = pairs_within(pos, float(radius.max()))
    ei, ej = radius[i] * 0.5, radius[j] * 0.5
    delta = pos[i] - pos[j]
    dist = norm(delta)
    overlap = (ei + ej) - dist
    touching = overlap > p["contact_epsilon"]
    dirv = delta / torch.clamp(dist, min=1e-12)[:, None]
    sum_r = ei + ej
    ofall = torch.clamp(overlap / sum_r, 0.0, 1.0)
    fall = torch.clamp(1.0 - dist / sum_r, 0.0, 1.0)
    rep = dirv * (fall * p["repulsion_strength"] * ofall)[:, None]
    surf_i = vel[i] + cross(om[i], -dirv * ei[:, None])
    surf_j = vel[j] + cross(om[j], dirv * ej[:, None])
    rel = surf_i - surf_j
    tangent = rel - dirv * dot(rel, dirv, keepdim=True)
    slip = norm(tangent)
    slipping = touching & (slip > p["slip_epsilon"])
    fdir = tangent / torch.clamp(slip, min=1e-20)[:, None]
    tin = torch.abs(slip * p["torque_factor"])
    fmag = torch.clamp(tin * torch.sqrt(torch.sqrt(tin)), max=10.0)
    arm = ofall ** 2 * ei * p["rolling_contact_radius_multiplier"]
    tq = cross(dirv * arm[:, None], fdir * fmag[:, None])
    force = torch.zeros_like(pos).index_add_(
        0, i, torch.where(touching[:, None], rep, 0.0))
    torque = torch.zeros_like(pos).index_add_(
        0, i, torch.where(slipping[:, None], tq, 0.0))
    return force, torque


def adhesion(pos, vel, rot, mass, bonds: dict, g: dict, dt: float,
             enabled: bool):
    """(Δv, Δq) per cell from every bond's spring, anchor swing and
    relative-orientation constraints (genome mode 0's values); `enabled`
    switches the anchor and orientation constraints."""
    ia, ib = bonds["ia"], bonds["ib"]
    pa, pb, va, vb = pos[ia], pos[ib], vel[ia], vel[ib]
    qa, qb = rot[ia], rot[ib]
    delta = pb - pa
    dist = norm(delta)
    spring_ok = dist > 1e-6
    dirv = delta / torch.clamp(dist, min=1e-20)[:, None]
    force = dirv * ((dist - g["adhesion_rest_length"])
                    * g["adhesion_spring_stiffness"])[:, None]
    force = force + dirv * (dot(vb - va, dirv)
                            * g["adhesion_spring_damping"])[:, None]
    dv_a = torch.where(spring_ok[:, None], force / mass[ia][:, None] * dt,
                       0.0)
    dv_b = torch.where(spring_ok[:, None], -force / mass[ib][:, None] * dt,
                       0.0)

    strength = g["orientation_constraint_strength"] * 10.0 * dt
    a_vec = (pb + qrotate(qb, bonds["anchor_b"])
             - (pa + qrotate(qa, bonds["anchor_a"])))
    a_len = norm(a_vec, keepdim=True)
    anchor_ok = (a_len[:, 0] > 1e-6) & enabled
    a_dir = a_vec / torch.clamp(a_len, min=1e-20)

    def swing(q, anchor, desired):
        r_world = qrotate(q, anchor)
        axis = cross(r_world, desired)
        alen = norm(axis)
        axis_n = axis / torch.clamp(alen, min=1e-20)[:, None]
        eff = torch.abs(dot(cross(axis_n, r_world), desired))
        ok = anchor_ok & (alen > 1e-6) & (eff > 1e-6)
        dq = qmul(qaxis_angle(axis_n, strength * eff * 5.0), q) - q
        return torch.where(ok[:, None], dq, 0.0)

    dq_a = swing(qa, bonds["anchor_a"], a_dir)
    dq_b = swing(qb, bonds["anchor_b"], -a_dir)
    corr = qmul(bonds["rel_orientation"], qconj(qmul(qconj(qa), qb)))
    cv = corr[:, :3]
    cangle = 2.0 * torch.atan2(norm(cv), torch.abs(corr[:, 3]))
    orient_ok = (cangle > 1e-6) & enabled
    caxis = cv / torch.clamp(norm(cv), min=1e-20)[:, None]
    half = strength * 2.0 * cangle * 0.5
    dq_a = dq_a + torch.where(orient_ok[:, None],
                              qmul(qaxis_angle(caxis, -half), qa) - qa, 0.0)
    dq_b = dq_b + torch.where(orient_ok[:, None],
                              qmul(qaxis_angle(caxis, half), qb) - qb, 0.0)
    dv = torch.zeros_like(pos).index_add_(0, ia, dv_a).index_add_(0, ib,
                                                                  dv_b)
    dq = torch.zeros_like(rot).index_add_(0, ia, dq_a).index_add_(0, ib,
                                                                  dq_b)
    return dv, dq


def step(s: dict, cells: dict, bonds: dict, p: dict, g: dict) -> dict:
    """One step of the state s = {pos, vel, ang, rot}."""
    dt = p["dt"]
    pos, vel, ang, rot = s["pos"], s["vel"], s["ang"], s["rot"]
    mass, inertia = cells["mass"], cells["inertia"]
    force, torque = contact(pos, vel, ang, cells["radius"], p)
    vel = vel + force / mass[:, None] * dt
    ang = ang + torque / inertia[:, None] * dt
    accum = torque * dt

    dv, dq = adhesion(pos, vel, rot, mass, bonds, g, dt,
                      bool(p["enable_anchor_constraints"]))
    vel = vel + dv
    rot = qnormalize(rot + dq)

    ang_damp = math.exp(-p["torque_damping"] * dt)
    vel = vel * torch.exp(-cells["drag"] * p["global_drag_multiplier"]
                          * dt)[:, None]
    ang = ang * ang_damp
    pos_n = pos + vel * dt
    dist = norm(pos_n)
    out = (dist > p["spawn_radius"])[:, None]
    nrm = pos_n / torch.clamp(dist, min=1e-12)[:, None]
    vel_b = vel - 2.0 * dot(vel, nrm, keepdim=True) * nrm
    tang = vel_b - dot(vel_b, nrm, keepdim=True) * nrm
    fr = tang + 1e-6
    fdir = fr / torch.clamp(norm(fr, keepdim=True), min=1e-20)
    fmag = norm(tang) * p["boundary_friction"]
    eff_r = cells["radius"] * p["rolling_contact_radius_multiplier"]
    ang_b = ang + cross(nrm * eff_r[:, None], fdir * fmag[:, None]) / (
        inertia[:, None]) * dt
    pos = torch.where(out, nrm * p["spawn_radius"], pos_n)
    vel = torch.where(out, vel_b, vel)
    ang = torch.where(out, ang_b, ang)

    ang = (ang + accum / inertia[:, None]) * ang_damp
    w_dt = ang * dt
    angle = norm(w_dt, keepdim=True)
    axis = w_dt / torch.clamp(angle, min=1e-20)
    dq_rot = torch.cat([axis * torch.sin(angle * 0.5),
                        torch.cos(angle * 0.5)], -1)
    rot = torch.where(angle > 1e-5, qnormalize(qmul(dq_rot, rot)), rot)
    return {"pos": pos, "vel": vel, "ang": ang, "rot": rot}


def run(s: dict, cells: dict, bonds: dict, p: dict, g: dict, steps: int,
        dtype=torch.float32) -> dict:
    """`steps` steps from the state s in `dtype`; float32 out."""
    def cast(d):
        return {k: v.to(dtype) if v.is_floating_point() else v
                for k, v in d.items()}

    s, cells, bonds = cast(s), cast(cells), cast(bonds)
    for _ in range(steps):
        s = step(s, cells, bonds, p, g)
    return {k: v.float() for k, v in s.items()}
