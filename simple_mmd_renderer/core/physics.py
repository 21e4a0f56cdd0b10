"""Batched rigid-body physics for MMD hair/skirt simulation.

Array replacement for the reference's Bullet binding (`mmd-bullet/
mmd-bullet_impl.inl`): fixed-shape arrays of bodies and joints, vectorized
(Jacobi-averaged) position-based constraint iterations inside `lax.scan`-style
substeps, all jit/vmap-friendly. Semantics mirrored from the binding:

- world gravity = 9.8 * direction * 10 ("world is scaled by 10",
  mmd-bullet_impl.inl:75); static ground plane y=0, friction 0.265 (:76-88)
- bodies: sphere/box/capsule from PMX dims; kinematic bodies driven from the
  animated bone (`PoserMotionState::Reset`, :21-26, 58-61); collision filter
  (1<<group, mask) used exactly as libmmd passes it to Bullet (:205)
- joints: btGeneric6DofSpringConstraint — frames localized into each body at
  rest (:229-231), per-axis linear/angular limits, springs enabled on all six
  axes with PMX stiffness (:234-245)
- `React(step)`: integrate + solve, then Synchronize (body -> bone skinning
  matrix for dynamic non-ghost bodies, :34-40), then Fix (PHYSICS_STRICT
  bones re-pin translation, :42-56)

Contact material response mirrors Bullet's combination rules: friction and
restitution combine multiplicatively across the two bodies
(`btManifoldResult::calculateCombined{Friction,Restitution}`); the reference's
ground plane has friction 0.265 (mmd-bullet_impl.inl:76-88) and Bullet-default
restitution 0 (never set). Friction is the standard XPBD positional form —
the tangential contact-point displacement accumulated over the substep is
cancelled, capped by mu * (normal correction), which reduces to Coulomb
dynamic friction for sliding bodies and exact sticking below the cap.
Restitution is a velocity-level pass after the position solve.

Divergences from Bullet (documented, qualitative parity is the goal): the
solver is positional (XPBD-style) rather than sequential-impulse. Contact
generation: box-box pairs run a separating-axis test over Bullet's axis set
(6 face axes + 9 edge crosses) and emit up-to-4-point corner manifolds;
box-floor and capsule-floor contacts are 4-corner / 2-endpoint manifolds
(Bullet's persistent 4-point manifolds, which resting stacks rely on);
sphere/capsule-vs-box remains a single closest-point contact per pair.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..formats import pmx as P
from ..utils import math3d as m3
from ..utils import pytree
from .model import ModelStatic
from .pose import PoseArrays

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Static build
# ---------------------------------------------------------------------------

@dataclass
class PhysicsStatic:
    n_bodies: int
    n_joints: int
    bone: np.ndarray          # [R] i32 (safe index; -1 -> 0)
    has_bone: np.ndarray      # [R] bool
    kinematic: np.ndarray     # [R] bool
    strict: np.ndarray        # [R] bool
    ghost: np.ndarray         # [R] bool
    shape: np.ndarray         # [R] i32
    dims: np.ndarray          # [R,3]
    inv_mass: np.ndarray      # [R]
    inv_inertia: np.ndarray   # [R,3] local diagonal
    lin_damp: np.ndarray      # [R]
    ang_damp: np.ndarray      # [R]
    friction: np.ndarray      # [R]
    restitution: np.ndarray   # [R]
    rest_quat: np.ndarray     # [R,4] body frame rotation (YXZ euler)
    rest_pos: np.ndarray      # [R,3] body frame origin
    writeback: np.ndarray     # [R] bool — dynamic, non-ghost, last body on bone
    pair_i: np.ndarray        # [Pn] i32 candidate collision pairs
    pair_j: np.ndarray        # [Pn]
    # joints
    j_a: np.ndarray           # [C] i32
    j_b: np.ndarray           # [C]
    j_qa: np.ndarray          # [C,4] constraint frame rotation in body a
    j_ta: np.ndarray          # [C,3] constraint frame origin in body a
    j_qb: np.ndarray          # [C,4]
    j_tb: np.ndarray          # [C,3]
    j_lin_lo: np.ndarray      # [C,3]
    j_lin_hi: np.ndarray      # [C,3]
    j_ang_lo: np.ndarray      # [C,3]
    j_ang_hi: np.ndarray      # [C,3]
    j_k_lin: np.ndarray       # [C,3] spring stiffness
    j_k_ang: np.ndarray       # [C,3]
    body_joint_count: np.ndarray  # [R] joints touching each body (Jacobi avg)
    body_pair_count: np.ndarray   # [R] candidate contacts per body
    # static incidence matrices: row aggregation as dense matmuls instead of
    # scatter-adds with duplicate indices; constraint topology is static, so
    # S[r, k] = count_scale[r] when row k touches body r turns every Jacobi
    # accumulation into one [R, K] @ [K, 3] matmul.
    s_joint_a: np.ndarray     # [R, 6C] (count-scaled, joint row -> body a)
    s_joint_b: np.ndarray     # [R, 6C]
    s_pair_a: np.ndarray      # [R, Pn]
    s_pair_b: np.ndarray      # [R, Pn]


@pytree.dataclass
class PhysicsState:
    pos: jnp.ndarray     # [R,3]
    quat: jnp.ndarray    # [R,4]
    vel: jnp.ndarray     # [R,3]
    omega: jnp.ndarray   # [R,3]


def _shape_inertia(shape, dims, mass):
    """Local diagonal inertia like Bullet's calculateLocalInertia."""
    if mass <= 0:
        return np.zeros(3, np.float32)
    x, y, z = float(dims[0]), float(dims[1]), float(dims[2])
    if shape == P.SHAPE_SPHERE:
        i = 0.4 * mass * x * x
        return np.array([i, i, i], np.float32)
    if shape == P.SHAPE_BOX:
        return (mass / 3.0) * np.array(
            [y * y + z * z, x * x + z * z, x * x + y * y], np.float32)
    # capsule (radius x, cylinder height y, axis Y) — Bullet's approximation
    r, h = x, y
    # treat as box-ish like btCapsuleShape::calculateLocalInertia
    half = np.array([r, r + 0.5 * h, r], np.float32)
    lx, ly, lz = 2 * half
    return (mass / 12.0) * np.array(
        [ly * ly + lz * lz, lx * lx + lz * lz, lx * lx + ly * ly], np.float32)


def _yxz_quat(e):
    """YXZ euler -> quat (body/constraint frames, mmd-bullet_impl.inl:183)."""
    cx, sx = np.cos(e[0] * 0.5), np.sin(e[0] * 0.5)
    cy, sy = np.cos(e[1] * 0.5), np.sin(e[1] * 0.5)
    cz, sz = np.cos(e[2] * 0.5), np.sin(e[2] * 0.5)
    return np.array([
        sx * cy * cz + cx * sy * sz,
        cx * sy * cz - sx * cy * sz,
        cx * cy * sz - sx * sy * cz,
        cx * cy * cz + sx * sy * sz], np.float32)


def _q_conj_np(q):
    return np.array([-q[0], -q[1], -q[2], q[3]], np.float32)


def _q_mul_np(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by + ay * bw + az * bx - ax * bz,
        aw * bz + az * bw + ax * by - ay * bx,
        aw * bw - (ax * bx + ay * by + az * bz)], np.float32)


def _q_rot_np(q, v):
    qv = q[:3]
    t = 2.0 * np.cross(qv, v)
    return v + q[3] * t + np.cross(qv, t)


def build_physics(static: ModelStatic) -> PhysicsStatic:
    bodies = static.rigid_bodies
    joints = static.constraints
    r = len(bodies)
    c = len(joints)

    bone = np.zeros(r, np.int32)
    has_bone = np.zeros(r, bool)
    kin = np.zeros(r, bool)
    strict = np.zeros(r, bool)
    ghost = np.zeros(r, bool)
    shape = np.zeros(r, np.int32)
    dims = np.zeros((r, 3), np.float32)
    inv_mass = np.zeros(r, np.float32)
    inv_inertia = np.zeros((r, 3), np.float32)
    lin_damp = np.zeros(r, np.float32)
    ang_damp = np.zeros(r, np.float32)
    friction = np.zeros(r, np.float32)
    restitution = np.zeros(r, np.float32)
    rest_quat = np.tile(np.array([0, 0, 0, 1], np.float32), (r, 1))
    rest_pos = np.zeros((r, 3), np.float32)
    group = np.zeros(r, np.int32)
    mask = np.zeros(r, np.int32)

    for i, b in enumerate(bodies):
        bone[i] = max(b.bone, 0)
        has_bone[i] = b.bone >= 0
        kin[i] = b.type == P.RIGID_KINEMATIC
        strict[i] = b.type == P.RIGID_PHYSICS_STRICT
        ghost[i] = b.type == P.RIGID_PHYSICS_GHOST
        shape[i] = b.shape
        dims[i] = b.dimensions
        if not kin[i] and b.mass > 0:
            inv_mass[i] = 1.0 / b.mass
            inertia = _shape_inertia(b.shape, b.dimensions, b.mass)
            inv_inertia[i] = np.where(inertia > 0, 1.0 / np.maximum(inertia, 1e-12), 0.0)
        lin_damp[i] = b.linear_damping
        ang_damp[i] = b.angular_damping
        friction[i] = b.friction
        restitution[i] = b.restitution
        rest_quat[i] = _yxz_quat(b.rotation)
        rest_pos[i] = b.position
        group[i] = b.group
        mask[i] = b.mask

    # last dynamic non-ghost body per bone wins the skinning write-back
    writeback = np.zeros(r, bool)
    seen = set()
    for i in range(r - 1, -1, -1):
        if (not kin[i]) and (not ghost[i]) and has_bone[i]:
            bi = int(bone[i])
            if bi not in seen:
                writeback[i] = True
                seen.add(bi)

    # candidate pairs with the reference's Bullet-style filter:
    # (1<<group_a) & mask_b  and  (1<<group_b) & mask_a, at least one dynamic
    pi, pj = [], []
    for i in range(r):
        for j in range(i + 1, r):
            if kin[i] and kin[j]:
                continue
            if ((1 << group[i]) & mask[j]) and ((1 << group[j]) & mask[i]):
                pi.append(i)
                pj.append(j)

    j_a = np.zeros(c, np.int32)
    j_b = np.zeros(c, np.int32)
    j_qa = np.tile(np.array([0, 0, 0, 1], np.float32), (c, 1))
    j_ta = np.zeros((c, 3), np.float32)
    j_qb = np.tile(np.array([0, 0, 0, 1], np.float32), (c, 1))
    j_tb = np.zeros((c, 3), np.float32)
    j_lin_lo = np.zeros((c, 3), np.float32)
    j_lin_hi = np.zeros((c, 3), np.float32)
    j_ang_lo = np.zeros((c, 3), np.float32)
    j_ang_hi = np.zeros((c, 3), np.float32)
    j_k_lin = np.zeros((c, 3), np.float32)
    j_k_ang = np.zeros((c, 3), np.float32)

    for i, jt in enumerate(joints):
        a = max(jt.body_a, 0)
        b = max(jt.body_b, 0)
        j_a[i], j_b[i] = a, b
        qc = _yxz_quat(jt.rotation)
        tc = jt.position.astype(np.float32)
        # localize the constraint frame into each body's rest frame
        for q_out, t_out, body in ((j_qa, j_ta, a), (j_qb, j_tb, b)):
            qi = _q_conj_np(rest_quat[body])
            q_out[i] = _q_mul_np(qi, qc)
            t_out[i] = _q_rot_np(qi, tc - rest_pos[body])
        j_lin_lo[i], j_lin_hi[i] = jt.pos_lo, jt.pos_hi
        j_ang_lo[i], j_ang_hi[i] = jt.rot_lo, jt.rot_hi
        j_k_lin[i] = jt.spring_translate
        j_k_ang[i] = jt.spring_rotate

    body_joint_count = np.ones(r, np.float32)
    for i in range(c):
        body_joint_count[j_a[i]] += 1
        body_joint_count[j_b[i]] += 1
    body_pair_count = np.ones(r, np.float32)
    for a, b in zip(pi, pj):
        body_pair_count[a] += 1
        body_pair_count[b] += 1

    def incidence(idx, count):
        s = np.zeros((r, len(idx)), np.float32)
        s[idx, np.arange(len(idx))] = 1.0 / count[idx]
        return s

    # joint rows are laid out axis-major then (hard, spring):
    # [x*C, y*C, z*C] twice — matching _joint_pass's rows3/tile order
    idx6_a = np.tile(np.tile(j_a, 3), 2)
    idx6_b = np.tile(np.tile(j_b, 3), 2)
    pi_arr = np.asarray(pi, np.int32)
    pj_arr = np.asarray(pj, np.int32)

    return PhysicsStatic(
        n_bodies=r, n_joints=c, bone=bone, has_bone=has_bone, kinematic=kin,
        strict=strict, ghost=ghost, shape=shape, dims=dims, inv_mass=inv_mass,
        inv_inertia=inv_inertia, lin_damp=lin_damp, ang_damp=ang_damp,
        friction=friction, restitution=restitution,
        rest_quat=rest_quat, rest_pos=rest_pos,
        writeback=writeback,
        pair_i=pi_arr, pair_j=pj_arr,
        j_a=j_a, j_b=j_b, j_qa=j_qa, j_ta=j_ta, j_qb=j_qb, j_tb=j_tb,
        j_lin_lo=j_lin_lo, j_lin_hi=j_lin_hi, j_ang_lo=j_ang_lo,
        j_ang_hi=j_ang_hi, j_k_lin=j_k_lin, j_k_ang=j_k_ang,
        body_joint_count=body_joint_count, body_pair_count=body_pair_count,
        s_joint_a=incidence(idx6_a, body_joint_count),
        s_joint_b=incidence(idx6_b, body_joint_count),
        s_pair_a=incidence(pi_arr, body_pair_count),
        s_pair_b=incidence(pj_arr, body_pair_count))


# ---------------------------------------------------------------------------
# Animation-driven body targets (PoserMotionState::Reset)
# ---------------------------------------------------------------------------

def _mat_to_quat(m):
    """Rotation 3x3 -> quaternion (x,y,z,w), branch-free-ish."""
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    qw = jnp.sqrt(jnp.maximum(1.0 + t, 1e-12)) * 0.5
    qx = (m[..., 2, 1] - m[..., 1, 2]) / (4 * jnp.maximum(qw, 1e-6))
    qy = (m[..., 0, 2] - m[..., 2, 0]) / (4 * jnp.maximum(qw, 1e-6))
    qz = (m[..., 1, 0] - m[..., 0, 1]) / (4 * jnp.maximum(qw, 1e-6))
    q = jnp.stack([qx, qy, qz, qw], -1)
    return m3.quat_normalize(q)


def body_targets(ps: PhysicsStatic, pose: PoseArrays):
    """World transform each body would have if rigidly following its animated
    bone: W = skin[bone] @ rest_frame (mmd-bullet_impl.inl:58-61)."""
    skin = pose.skin[jnp.asarray(ps.bone)]
    rq = jnp.asarray(ps.rest_quat)
    rp = jnp.asarray(ps.rest_pos)
    rot = skin[:, :3, :3]
    pos = jnp.einsum("rij,rj->ri", rot, rp) + skin[:, :3, 3]
    quat = m3.quat_mul(_mat_to_quat(rot), rq)
    return pos, quat


def physics_reset(ps: PhysicsStatic, pose: PoseArrays) -> PhysicsState:
    """Seed body states from the current animation pose, zero velocities
    (BulletPhysicsReactor::Reset, mmd-bullet_impl.inl:285-310)."""
    pos, quat = body_targets(ps, pose)
    return PhysicsState(pos=pos, quat=quat,
                        vel=jnp.zeros_like(pos),
                        omega=jnp.zeros_like(pos))


# ---------------------------------------------------------------------------
# Contacts
# ---------------------------------------------------------------------------

def _capsule_segment(dims, pos, quat):
    """Capsule axis endpoints (axis = local Y, half-length h/2)."""
    half = dims[..., 1:2] * 0.5
    axis = m3.quat_rotate(quat, jnp.broadcast_to(
        jnp.asarray([0.0, 1.0, 0.0], jnp.float32), pos.shape))
    return pos - axis * half, pos + axis * half


def _closest_on_segment(p, a, b):
    ab = b - a
    t = jnp.sum((p - a) * ab, -1) / jnp.maximum(jnp.sum(ab * ab, -1), _EPS)
    t = jnp.clip(t, 0.0, 1.0)
    return a + t[..., None] * ab


def _segment_segment(a0, a1, b0, b1):
    """Approximate closest points between segments (iterative projection)."""
    p = (a0 + a1) * 0.5
    q = _closest_on_segment(p, b0, b1)
    for _ in range(3):
        p = _closest_on_segment(q, a0, a1)
        q = _closest_on_segment(p, b0, b1)
    return p, q


def _point_box_depth(p_local, half):
    """Penetration of a point into an axis-aligned box (local frame).
    Returns (depth, normal_local): depth > 0 when inside/overlapping."""
    d = half - jnp.abs(p_local)
    inside = jnp.all(d > 0, -1)
    # nearest face
    axis = jnp.argmin(d, -1)
    sgn = jnp.sign(jnp.take_along_axis(p_local, axis[..., None], -1))[..., 0]
    n_local = jax.nn.one_hot(axis, 3, dtype=p_local.dtype) * sgn[..., None]
    depth_in = jnp.take_along_axis(d, axis[..., None], -1)[..., 0]
    # outside: clamp point to box, sphere-vs-point handled by caller via radius
    clamped = jnp.clip(p_local, -half, half)
    out_vec = p_local - clamped
    out_dist = jnp.linalg.norm(out_vec, axis=-1)
    n_out = out_vec / jnp.maximum(out_dist, _EPS)[..., None]
    depth = jnp.where(inside, depth_in, -out_dist)
    normal = jnp.where(inside[..., None], n_local, n_out)
    return depth, normal


def _sphere_rad(shape, dims):
    return jnp.where(shape == P.SHAPE_SPHERE, dims[..., 0],
                     jnp.where(shape == P.SHAPE_CAPSULE, dims[..., 0], 0.0))


# manifold slots per candidate pair / per ground contact: Bullet's persistent
# manifolds hold up to 4 points, which is what lets a resting box balance
# torque instead of rocking on a single contact
PAIR_MANIFOLD = 4
GROUND_MANIFOLD = 4
_NO_CONTACT = -1e9   # inactive-slot depth: stays negative under any motion

# Jacobi rounds of the post-solve contact velocity pass (physics_substep):
# round k leaves a (1 - 1/count)^k residual of the per-body contact-count
# under-application; 4 rounds ~ <32% residual at 4-way contact sharing
VELOCITY_PASS_ITERS = 4

_CORNER_SIGNS = np.asarray(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
    np.float32)  # [8,3]


def _box_box_manifold(xi, qi, di, xj, qj, dj):
    """SAT + corner manifold for box-box pairs (vectorized over K).

    Returns (point [K,4,3], normal [K,4,3] oriented j->i, depth [K,4],
    deepest slot first; signed — negative when separated). Detection is a
    separating-axis test over the 6 face axes and 9 edge-cross axes
    (Bullet's btBoxBoxDetector axis set; the reference creates btBoxShape
    bodies at mmd-bullet_impl.inl:171-172 and relies on Bullet's 4-point
    persistent manifolds for resting contact). Manifold points are the
    up-to-4 deepest of 16 corner-penetration candidates (each box's 8
    corners tested against the other); when the SAT overlaps but no corner
    is inside (edge-edge crossing), one contact at the midpoint of centers
    carries the SAT depth along the SAT axis."""
    ri = m3.quat_to_mat3(qi)            # [K,3,3], columns = local axes
    rj = m3.quat_to_mat3(qj)
    d = xi - xj                          # [K,3]

    face_i = jnp.transpose(ri, (0, 2, 1))   # [K,3,3] rows = world axes
    face_j = jnp.transpose(rj, (0, 2, 1))
    cross = jnp.cross(face_i[:, :, None, :], face_j[:, None, :, :])
    axes = jnp.concatenate([face_i, face_j, cross.reshape(-1, 9, 3)], 1)
    norm = jnp.linalg.norm(axes, axis=-1)                       # [K,15]
    unit = axes / jnp.maximum(norm, _EPS)[..., None]
    ext_i = jnp.sum(di[:, None, :]
                    * jnp.abs(jnp.einsum("kna,kab->knb", unit, ri)), -1)
    ext_j = jnp.sum(dj[:, None, :]
                    * jnp.abs(jnp.einsum("kna,kab->knb", unit, rj)), -1)
    sep = jnp.abs(jnp.einsum("kna,ka->kn", unit, d))
    overlap = ext_i + ext_j - sep                               # [K,15]
    # near-parallel edge pairs give a degenerate cross axis: not a valid
    # separating direction, exclude from the min
    overlap = jnp.where(norm > 1e-6, overlap, jnp.float32(np.inf))
    k_min = jnp.argmin(overlap, axis=1)
    sat_depth = jnp.take_along_axis(overlap, k_min[:, None], 1)[:, 0]
    axis = jnp.take_along_axis(unit, k_min[:, None, None], 1)[:, 0]
    # orient j -> i (the solver pushes body i along +normal)
    axis = axis * jnp.where(jnp.sum(axis * d, -1) >= 0, 1.0, -1.0)[:, None]

    corners = jnp.asarray(_CORNER_SIGNS)
    cj_w = xj[:, None, :] + jnp.einsum(
        "kab,knb->kna", rj, corners[None] * dj[:, None, :])     # [K,8,3]
    ci_w = xi[:, None, :] + jnp.einsum(
        "kab,knb->kna", ri, corners[None] * di[:, None, :])
    # depth of j's corners inside box i (local-frame point-box test)
    lj_in_i = jnp.einsum("kba,knb->kna", ri, cj_w - xi[:, None, :])
    dj_in_i, _ = _point_box_depth(lj_in_i, di[:, None, :])      # [K,8]
    li_in_j = jnp.einsum("kba,knb->kna", rj, ci_w - xj[:, None, :])
    di_in_j, _ = _point_box_depth(li_in_j, dj[:, None, :])
    cand_p = jnp.concatenate([cj_w, ci_w], 1)                   # [K,16,3]
    # nearest-face depth can exceed the true overlap for deep corners; the
    # SAT depth is exact along the manifold normal, so cap at it
    cand_d = jnp.minimum(jnp.concatenate([dj_in_i, di_in_j], 1),
                         sat_depth[:, None])

    vals, idx = jax.lax.top_k(cand_d, PAIR_MANIFOLD)            # [K,4]
    pts = jnp.take_along_axis(cand_p, idx[..., None], 1)        # [K,4,3]
    any_corner = vals[:, 0] > 0
    mid = (xi + xj) * 0.5
    depth0 = jnp.where(any_corner, vals[:, 0], sat_depth)
    point0 = jnp.where(any_corner[:, None], pts[:, 0], mid)
    rest_d = jnp.where(any_corner[:, None], vals[:, 1:],
                       jnp.float32(_NO_CONTACT))
    depth = jnp.concatenate([depth0[:, None], rest_d], 1)
    point = jnp.concatenate([point0[:, None], pts[:, 1:]], 1)
    normal = jnp.broadcast_to(axis[:, None, :], point.shape)
    return point, normal, depth


def pair_contacts(ps: PhysicsStatic, pos, quat):
    """Manifold contacts per candidate pair: (point [K,M,3], normal
    [K,M,3] i<-j, depth [K,M], deepest slot first, signed). M is STATIC
    from the rig's shape content: 1 when no candidate pair is box-box
    (spheres/capsules and mixed pairs need one contact — the common MMD
    hair rig pays zero manifold overhead), else PAIR_MANIFOLD with the
    SAT corner manifold (_box_box_manifold) computed only on the static
    box-box subset."""
    if len(ps.pair_i) == 0:
        z = jnp.zeros((0, 1, 3), jnp.float32)
        return z, z, jnp.zeros((0, 1), jnp.float32)
    i = jnp.asarray(ps.pair_i)
    j = jnp.asarray(ps.pair_j)
    shape = jnp.asarray(ps.shape)
    dims = jnp.asarray(ps.dims)
    si, sj = shape[i], shape[j]
    di, dj = dims[i], dims[j]
    xi, xj = pos[i], pos[j]
    qi, qj = quat[i], quat[j]

    # representative segment for each body: sphere/box -> degenerate at
    # center; capsule -> its axis. Boxes get a closest-point correction.
    a0i, a1i = _capsule_segment(di, xi, qi)
    a0j, a1j = _capsule_segment(dj, xj, qj)
    cap_i = (si == P.SHAPE_CAPSULE)[..., None]
    cap_j = (sj == P.SHAPE_CAPSULE)[..., None]
    a0i = jnp.where(cap_i, a0i, xi)
    a1i = jnp.where(cap_i, a1i, xi)
    a0j = jnp.where(cap_j, a0j, xj)
    a1j = jnp.where(cap_j, a1j, xj)
    pi_, pj_ = _segment_segment(a0i, a1i, a0j, a1j)

    ri = _sphere_rad(si, di)
    rj = _sphere_rad(sj, dj)

    # sphere/capsule vs sphere/capsule
    delta = pi_ - pj_
    dist = jnp.linalg.norm(delta, axis=-1)
    n_ss = delta / jnp.maximum(dist, _EPS)[..., None]
    depth_ss = ri + rj - dist
    point_ss = (pi_ + pj_) * 0.5

    # something vs box: closest point of the other body's segment-sphere in
    # the box frame
    def vs_box(box_x, box_q, box_half, other_p, other_r):
        local = m3.quat_rotate(m3.quat_conj(box_q), other_p - box_x)
        depth, n_local = _point_box_depth(local, box_half)
        n_world = m3.quat_rotate(box_q, n_local)
        return depth + other_r, n_world

    box_i = si == P.SHAPE_BOX
    box_j = sj == P.SHAPE_BOX
    depth_ib, n_ib = vs_box(xi, qi, di, pj_, rj)   # j into box i: normal j->out
    depth_jb, n_jb = vs_box(xj, qj, dj, pi_, ri)   # i into box j

    # single-contact slot for mixed pairs: normal from the box toward the
    # other body
    depth1 = jnp.where(box_j & ~box_i, depth_jb,
                       jnp.where(box_i & ~box_j, depth_ib, depth_ss))
    normal1 = jnp.where((box_j & ~box_i)[..., None], n_jb,
                        jnp.where((box_i & ~box_j)[..., None], -n_ib, n_ss))
    point1 = point_ss  # adequate for positional correction

    # box-box: SAT + 4-point corner manifold (Bullet parity for resting
    # skirt/stack rigs; the old min-half-extent center proxy both missed
    # face-to-face contact on elongated boxes and could never balance
    # one). The subset is STATIC (shapes are rig constants): rigs without
    # box-box pairs keep M=1 rows and skip the SAT entirely.
    sh_np = np.asarray(ps.shape)
    bb = np.nonzero((sh_np[ps.pair_i] == P.SHAPE_BOX)
                    & (sh_np[ps.pair_j] == P.SHAPE_BOX))[0]
    if len(bb) == 0:
        return point1[:, None, :], normal1[:, None, :], depth1[:, None]

    pm, nm, dm = _box_box_manifold(xi[bb], qi[bb], di[bb],
                                   xj[bb], qj[bb], dj[bb])
    k = depth1.shape[0]
    depth = jnp.concatenate(
        [depth1[:, None],
         jnp.full((k, PAIR_MANIFOLD - 1), _NO_CONTACT, jnp.float32)], 1)
    point = jnp.broadcast_to(point1[:, None, :],
                             (k, PAIR_MANIFOLD, 3))
    normal = jnp.broadcast_to(normal1[:, None, :],
                              (k, PAIR_MANIFOLD, 3))
    bbj = jnp.asarray(bb)
    depth = depth.at[bbj].set(dm)
    point = point.at[bbj].set(pm)
    normal = normal.at[bbj].set(nm)
    return point, normal, depth


def ground_contacts(ps: PhysicsStatic, pos, quat):
    """Manifold contacts against the static y=0 plane
    (mmd-bullet_impl.inl:76-88). Returns (depth [R,G], point [R,G,3]),
    deepest slot first, signed depths. Boxes contribute their 4 deepest
    corners (a resting box is torque-balanced like Bullet's 4-point
    manifold), capsules both axis endpoints (a lying capsule rests flat),
    spheres their center point. G is STATIC from the rig's shape content
    (4 with boxes, 2 with capsules, 1 spheres-only) — the common MMD hair
    rig pays for the slots it can actually use."""
    shape = jnp.asarray(ps.shape)
    dims = jnp.asarray(ps.dims)
    r = _sphere_rad(shape, dims)
    is_cap = shape == P.SHAPE_CAPSULE
    is_box = shape == P.SHAPE_BOX
    is_sph = ~is_cap & ~is_box

    sh_np = np.asarray(ps.shape)
    has_box = bool((sh_np == P.SHAPE_BOX).any())
    has_cap = bool((sh_np == P.SHAPE_CAPSULE).any())
    g_slots = GROUND_MANIFOLD if has_box else (2 if has_cap else 1)

    a0, a1 = _capsule_segment(dims, pos, quat)
    ends = jnp.stack([a0, a1], 1)                                # [R,2,3]
    d_cap = r[:, None] - ends[..., 1]
    d_sph = (r - pos[..., 1])[:, None]                           # [R,1]
    cand_p = [ends, pos[:, None, :]]
    cand_d = [jnp.where(is_cap[:, None], d_cap, _NO_CONTACT),
              jnp.where(is_sph[:, None], d_sph, _NO_CONTACT)]
    if has_box:
        # 8 box corners (computed only when the rig has boxes)
        corners = jnp.asarray(_CORNER_SIGNS)
        local = corners[None, :, :] * dims[:, None, :]
        world = m3.quat_rotate(quat[:, None, :], local) + pos[:, None, :]
        cand_p.insert(0, world)
        cand_d.insert(0, jnp.where(is_box[:, None], -world[..., 1],
                                   _NO_CONTACT))
    cand_p = jnp.concatenate(cand_p, 1)
    cand_d = jnp.concatenate(cand_d, 1)
    depth, idx = jax.lax.top_k(cand_d, g_slots)                  # [R,G]
    point = jnp.take_along_axis(cand_p, idx[..., None], 1)
    # point keeps its real y (the contact FEATURE on the body, not its
    # plane projection): with boxes in the rig, the solver re-derives each
    # slot's penetration per iteration from the feature's current world
    # height, which tracks rotation-induced motion the old
    # center-translation update missed
    return depth, point


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

def _inv_inertia_world(ps, quat):
    rot = m3.quat_to_mat3(quat)
    i_inv = jnp.asarray(ps.inv_inertia)
    return jnp.einsum("rij,rj,rkj->rik", rot, i_inv, rot)


def _apply_position_corrections(ps, pos, quat, idx_a, idx_b, n, c, r_a, r_b,
                                alpha, scat, dt, iiw=None):
    """Batched XPBD positional constraint projection with Jacobi averaging.

    For each row k: bodies (a,b), world direction n, violation c (positive =
    must separate along +n for a), anchors r (world, from body origin).
    `iiw` (world inverse inertia) may be precomputed per iteration.
    `scat` = (S_a [R,K], S_b [R,K]) count-scaled static incidence matrices:
    per-body accumulation is a dense matmul, not a scatter-add with
    duplicate indices.
    """
    inv_m = jnp.asarray(ps.inv_mass)
    if iiw is None:
        iiw = _inv_inertia_world(ps, quat)
    s_a, s_b = scat

    ra_x_n = jnp.cross(r_a, n)
    rb_x_n = jnp.cross(r_b, n)
    w_a = inv_m[idx_a] + jnp.einsum("ki,kij,kj->k", ra_x_n, iiw[idx_a], ra_x_n)
    w_b = inv_m[idx_b] + jnp.einsum("ki,kij,kj->k", rb_x_n, iiw[idx_b], rb_x_n)
    denom = w_a + w_b + alpha / (dt * dt)
    lam = -c / jnp.maximum(denom, _EPS)
    p = lam[..., None] * n

    dpos_a = p * inv_m[idx_a][..., None]
    dpos_b = -p * inv_m[idx_b][..., None]
    dw_a = jnp.einsum("kij,kj->ki", iiw[idx_a], jnp.cross(r_a, p))
    dw_b = -jnp.einsum("kij,kj->ki", iiw[idx_b], jnp.cross(r_b, p))

    # one [R,K]@[K,6] matmul aggregates both the translational and the
    # rotational row contributions
    acc = s_a @ jnp.concatenate([dpos_a, dw_a], -1) \
        + s_b @ jnp.concatenate([dpos_b, dw_b], -1)
    pos = pos + acc[:, :3]
    quat = _apply_small_rotation(quat, acc[:, 3:])
    return pos, quat


def _apply_ground_correction(ps, pos, quat, n, c, r, g_slots, dt, iiw):
    """Positional correction against the static ground (an infinite-mass
    virtual body): FLAT manifold rows ([R*G] violations, [R*G,3]
    normals/anchors, slot-minor so row k belongs to body k // G) apply
    directly with no incidence aggregation — the caller pre-divides
    violations by the active slot count so the summed translation matches
    a single full-depth contact while the per-anchor torques balance.
    Rows stay RANK-2 throughout: no [R,G,3]-shaped operands materialize at
    einsum boundaries under vmap.
    Resolving at the contact anchors gives the inertia-weighted torque
    Bullet's 4-point manifolds produce — a leaning capsule topples and a
    resting box stays flat instead of rocking on one corner."""
    inv_m = jnp.asarray(ps.inv_mass)
    im = jnp.repeat(inv_m, g_slots)                           # [RG]
    iiw_r = jnp.repeat(iiw, g_slots, axis=0)                  # [RG,3,3]
    r_x_n = jnp.cross(r, n)                                   # [RG,3]
    w = im + jnp.einsum("ki,kij,kj->k", r_x_n, iiw_r, r_x_n)
    lam = -c / jnp.maximum(w, _EPS)                           # [RG]
    p = lam[..., None] * n                                    # [RG,3]
    dp = (p * im[..., None]).reshape(-1, g_slots, 3).sum(1)
    pos = pos + dp
    torque = jnp.cross(r, p).reshape(-1, g_slots, 3).sum(1)   # [R,3]
    dw = jnp.einsum("kij,kj->ki", iiw, torque)
    return pos, _apply_small_rotation(quat, dw)


def _apply_velocity_corrections(ps, vel, omega, idx_a, idx_b, n, dv, r_a,
                                r_b, scat, iiw):
    """Velocity-level impulse rows (same Jacobi incidence aggregation as
    _apply_position_corrections, acting on velocities): drive each row's
    relative contact-point normal velocity by dv along n, with anchors r
    from the body origins."""
    inv_m = jnp.asarray(ps.inv_mass)
    s_a, s_b = scat
    ra_x_n = jnp.cross(r_a, n)
    rb_x_n = jnp.cross(r_b, n)
    w_a = inv_m[idx_a] + jnp.einsum("ki,kij,kj->k", ra_x_n, iiw[idx_a], ra_x_n)
    w_b = inv_m[idx_b] + jnp.einsum("ki,kij,kj->k", rb_x_n, iiw[idx_b], rb_x_n)
    lam = dv / jnp.maximum(w_a + w_b, _EPS)
    p = lam[..., None] * n
    dvel_a = p * inv_m[idx_a][..., None]
    dvel_b = -p * inv_m[idx_b][..., None]
    dw_a = jnp.einsum("kij,kj->ki", iiw[idx_a], jnp.cross(r_a, p))
    dw_b = -jnp.einsum("kij,kj->ki", iiw[idx_b], jnp.cross(r_b, p))
    acc = s_a @ jnp.concatenate([dvel_a, dw_a], -1) \
        + s_b @ jnp.concatenate([dvel_b, dw_b], -1)
    return vel + acc[:, :3], omega + acc[:, 3:]


def _apply_small_rotation(quat, w):
    dq = m3.quat_mul(jnp.concatenate([w, jnp.zeros_like(w[..., :1])], -1), quat)
    return m3.quat_normalize(quat + 0.5 * dq)


def _apply_angular_corrections(ps, quat, idx_a, idx_b, axis, c, alpha,
                               scat, dt, iiw=None):
    if iiw is None:
        iiw = _inv_inertia_world(ps, quat)
    s_a, s_b = scat
    w_a = jnp.einsum("ki,kij,kj->k", axis, iiw[idx_a], axis)
    w_b = jnp.einsum("ki,kij,kj->k", axis, iiw[idx_b], axis)
    denom = w_a + w_b + alpha / (dt * dt)
    lam = -c / jnp.maximum(denom, _EPS)
    p = lam[..., None] * axis
    dw_a = jnp.einsum("kij,kj->ki", iiw[idx_a], p)
    dw_b = -jnp.einsum("kij,kj->ki", iiw[idx_b], p)
    rot_acc = s_a @ dw_a + s_b @ dw_b
    return _apply_small_rotation(quat, rot_acc)


def _joint_pass(ps: PhysicsStatic, pos, quat, dt, iiw=None):
    """All 6DOF joint axes as batched constraint rows: 6C linear rows (3 hard
    limit + 3 spring) in one scatter, 6C angular rows in another."""
    if ps.n_joints == 0:
        return pos, quat
    a = jnp.asarray(ps.j_a)
    b = jnp.asarray(ps.j_b)
    scat = (jnp.asarray(ps.s_joint_a), jnp.asarray(ps.s_joint_b))

    qa = m3.quat_mul(quat[a], jnp.asarray(ps.j_qa))   # constraint frame (A)
    qb = m3.quat_mul(quat[b], jnp.asarray(ps.j_qb))
    pa = pos[a] + m3.quat_rotate(quat[a], jnp.asarray(ps.j_ta))
    pb = pos[b] + m3.quat_rotate(quat[b], jnp.asarray(ps.j_tb))
    frame = m3.quat_to_mat3(qa)                        # columns = axes

    lo = jnp.asarray(ps.j_lin_lo)
    hi = jnp.asarray(ps.j_lin_hi)
    k_lin = jnp.asarray(ps.j_k_lin)

    e = jnp.einsum("kij,kj->ki", jnp.transpose(frame, (0, 2, 1)), pb - pa)
    free = lo > hi
    target = jnp.clip(e, jnp.minimum(lo, hi), jnp.maximum(lo, hi))
    viol = jnp.where(free, 0.0, e - target)
    # spring toward 0 inside the limits (btGeneric6DofSpringConstraint with
    # equilibrium 0): soft constraint with compliance 1/k
    spring_on = k_lin > 0
    spring_viol = jnp.where(spring_on & (jnp.abs(viol) < 1e-12), e - 0.0, 0.0)
    alpha_spring = jnp.where(spring_on, 1.0 / jnp.maximum(k_lin, 1e-6), 1e12)

    r_a = pa - pos[a]
    r_b = pb - pos[b]
    axes = jnp.transpose(frame, (0, 2, 1))            # [C,3(axis),3]

    def rows3(vals):  # [C,3] -> [3C]
        return vals.T.reshape(-1)

    def rows3v(vals):  # [C,3,3] by axis -> [3C,3]
        return jnp.transpose(vals, (1, 0, 2)).reshape(-1, 3)

    idx3_a = jnp.tile(a, 3)
    idx3_b = jnp.tile(b, 3)
    n_rows = jnp.concatenate([rows3v(axes), rows3v(axes)])
    c_rows = jnp.concatenate([-rows3(viol), -rows3(spring_viol)])
    alpha_rows = jnp.concatenate([jnp.zeros(3 * ps.n_joints, jnp.float32),
                                  rows3(alpha_spring)])
    pos, quat = _apply_position_corrections(
        ps, pos, quat, jnp.tile(idx3_a, 2), jnp.tile(idx3_b, 2), n_rows,
        c_rows, jnp.tile(rows3v(jnp.broadcast_to(r_a[:, None, :],
                                                 r_a.shape[:1] + (3, 3))), (2, 1)),
        jnp.tile(rows3v(jnp.broadcast_to(r_b[:, None, :],
                                         r_b.shape[:1] + (3, 3))), (2, 1)),
        alpha_rows, scat, dt, iiw=iiw)

    # angular: relative rotation decomposed on the A-frame axes (XYZ euler,
    # like Bullet's 6dof)
    q_rel = m3.quat_mul(m3.quat_conj(qa), qb)
    ang = m3.quat_to_euler(q_rel, "xyz")
    alo = jnp.asarray(ps.j_ang_lo)
    ahi = jnp.asarray(ps.j_ang_hi)
    k_ang = jnp.asarray(ps.j_k_ang)
    afree = alo > ahi
    atarget = jnp.clip(ang, jnp.minimum(alo, ahi), jnp.maximum(alo, ahi))
    aviol = jnp.where(afree, 0.0, ang - atarget)
    aspring_on = k_ang > 0
    aspring_viol = jnp.where(aspring_on & (jnp.abs(aviol) < 1e-12), ang, 0.0)
    aalpha = jnp.where(aspring_on, 1.0 / jnp.maximum(k_ang, 1e-6), 1e12)

    quat = _apply_angular_corrections(
        ps, quat, jnp.tile(idx3_a, 2), jnp.tile(idx3_b, 2),
        jnp.concatenate([rows3v(axes), rows3v(axes)]),
        jnp.concatenate([-rows3(aviol), -rows3(aspring_viol)]),
        jnp.concatenate([jnp.zeros(3 * ps.n_joints, jnp.float32),
                         rows3(aalpha)]),
        scat, dt, iiw=iiw)
    return pos, quat


def _contact_pass(ps: PhysicsStatic, pos, quat, cfg, dt, cache,
                  pos_detect, pos_prev, iiw=None):
    """Resolve the substep's cached contact set (detected once per substep,
    like Bullet's per-step narrowphase): normals and anchors stay fixed,
    penetration depth is re-estimated from body translation along the
    normal. Friction: the tangential contact displacement accumulated since
    the substep start (`pos_prev`) is cancelled, capped at mu * (this
    iteration's normal correction) — the XPBD positional Coulomb model."""
    inv_m = jnp.asarray(ps.inv_mass)
    fric = jnp.asarray(ps.friction)
    (c_point, c_n, c_depth0, c_la, c_lb, g_depth0, g_point, g_l,
     g_reff) = cache
    # pairwise: [K, M] manifold slots flattened slot-major to [M*K] rows;
    # violations are pre-divided by each pair's active slot count so a
    # 4-point resting face translates like one full-depth contact while the
    # per-anchor torques balance. Penetration is re-derived each iteration
    # from the localized anchors' CURRENT world positions (rotation-aware:
    # a corner push that rotates the body lifts that corner).
    if len(ps.pair_i):
        multi = c_depth0.ndim == 2   # manifold rigs keep the slot axis
        if multi:
            m_slots = c_depth0.shape[1]
            i = jnp.tile(jnp.asarray(ps.pair_i), m_slots)
            j = jnp.tile(jnp.asarray(ps.pair_j), m_slots)
            n_f = jnp.transpose(c_n, (1, 0, 2)).reshape(-1, 3)
            p_f = jnp.transpose(c_point, (1, 0, 2)).reshape(-1, 3)
            d0_f = c_depth0.T.reshape(-1)
            scat = (jnp.tile(jnp.asarray(ps.s_pair_a), (1, m_slots)),
                    jnp.tile(jnp.asarray(ps.s_pair_b), (1, m_slots)))
        else:
            i = jnp.asarray(ps.pair_i)
            j = jnp.asarray(ps.pair_j)
            n_f, p_f, d0_f = c_n, c_point, c_depth0
            scat = (jnp.asarray(ps.s_pair_a), jnp.asarray(ps.s_pair_b))
        if c_la is not None:
            la_f = (jnp.transpose(c_la, (1, 0, 2)).reshape(-1, 3)
                    if multi else c_la)
            lb_f = (jnp.transpose(c_lb, (1, 0, 2)).reshape(-1, 3)
                    if multi else c_lb)
            pt_a = pos[i] + m3.quat_rotate(quat[i], la_f)
            pt_b = pos[j] + m3.quat_rotate(quat[j], lb_f)
            # anchors coincided at detection (pt_a = pt_b = c_point), so
            # the separation gained since then is n . (pt_a - pt_b)
            depth_raw = d0_f - jnp.sum(n_f * (pt_a - pt_b), -1)
            r_a = pt_a - pos[i]
            r_b = pt_b - pos[j]
        else:
            # no boxes: center-translation depth update (cheap; anchors
            # from the detection point like r3)
            moved = jnp.sum(n_f * ((pos[i] - pos_detect[i])
                                   - (pos[j] - pos_detect[j])), -1)
            depth_raw = d0_f - moved
            r_a = p_f - pos[i]
            r_b = p_f - pos[j]
        if multi:
            act = (depth_raw > 0).reshape(m_slots, -1)
            inv_act = jnp.tile(
                1.0 / jnp.maximum(jnp.sum(act.astype(jnp.float32), 0), 1.0),
                m_slots)
            depth = jnp.maximum(depth_raw, 0.0) * inv_act
        else:
            inv_act = None   # single slot: active count is 0 or 1
            depth = jnp.maximum(depth_raw, 0.0)
        pos, quat = _apply_position_corrections(
            ps, pos, quat, i, j, n_f, -depth, r_a, r_b,
            jnp.zeros_like(depth), scat, dt, iiw=iiw)
        # friction: combined mu = mu_i * mu_j (Bullet's combination rule)
        mu = fric[i] * fric[j]
        rel = (pos[i] - pos_prev[i]) - (pos[j] - pos_prev[j])
        t_vec = rel - jnp.sum(rel * n_f, -1, keepdims=True) * n_f
        t_len = jnp.linalg.norm(t_vec, axis=-1)
        t_dir = t_vec / jnp.maximum(t_len, _EPS)[..., None]
        corr = jnp.minimum(t_len if inv_act is None else t_len * inv_act,
                           mu * depth)
        corr = jnp.where(depth > 0, corr, 0.0)
        pos, quat = _apply_position_corrections(
            ps, pos, quat, i, j, t_dir, corr, r_a, r_b,
            jnp.zeros_like(corr), scat, dt, iiw=iiw)
    # ground plane: G manifold slots per body as FLAT [R*G] rows (slot-
    # minor), resolved AT THE CONTACT POINTS with inertia weighting
    # (Bullet resolves manifold points; a pure center translation could
    # never topple a leaning body, and a single point could never rest a
    # flat box). With boxes, per-iteration depth comes from each feature's
    # current world height; without, from the center translation (cheap).
    g_slots = g_depth0.shape[1]
    gd0 = g_depth0.reshape(-1)                                # [RG]
    gp_f = g_point.reshape(-1, 3)
    if g_l is not None:
        gl_f = g_l.reshape(-1, 3)
        quat_r = jnp.repeat(quat, g_slots, axis=0)
        pos_r = jnp.repeat(pos, g_slots, axis=0)
        feat = pos_r + m3.quat_rotate(quat_r, gl_f)           # [RG,3]
        depth = g_reff.reshape(-1) - feat[..., 1]
        r_g = feat - pos_r
    else:
        depth = gd0 - jnp.repeat(pos[:, 1] - pos_detect[:, 1], g_slots)
        r_g = gp_f - jnp.repeat(pos_detect, g_slots, axis=0)
    depth = jnp.where(cfg.has_floor, jnp.maximum(depth, 0.0), 0.0)
    dyn = inv_m > 0
    # active-count normalization per body (tiny [R,G] bool reduce)
    inv_act_g = 1.0 / jnp.maximum(
        jnp.sum((depth > 0).reshape(-1, g_slots).astype(jnp.float32), 1),
        1.0)
    push = jnp.where(jnp.repeat(dyn, g_slots), depth, 0.0) \
        * jnp.repeat(inv_act_g, g_slots)
    n_up = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
                            push.shape + (3,))
    if iiw is None:
        iiw = _inv_inertia_world(ps, quat)
    pos, quat = _apply_ground_correction(ps, pos, quat, n_up, -push, r_g,
                                         g_slots, dt, iiw)
    # ground friction (reference plane friction 0.265, mmd-bullet_impl.inl:88)
    # at the same anchors: tangential center drift cancelled, Coulomb-capped
    # at mu * (normal correction at each point)
    mu_g = fric * cfg.floor_friction
    slide = (pos - pos_prev) * jnp.asarray([1.0, 0.0, 1.0], jnp.float32)
    s_len = jnp.linalg.norm(slide, axis=-1)
    s_dir = slide / jnp.maximum(s_len, _EPS)[..., None]        # [R,3]
    g_corr = jnp.minimum(jnp.repeat(s_len * inv_act_g, g_slots),
                         jnp.repeat(mu_g, g_slots) * push)
    g_corr = jnp.where((push > 0) & jnp.repeat(dyn, g_slots), g_corr, 0.0)
    pos, quat = _apply_ground_correction(
        ps, pos, quat, jnp.repeat(s_dir, g_slots, axis=0), g_corr, r_g,
        g_slots, dt, iiw)
    return pos, quat


def physics_substep(ps: PhysicsStatic, state: PhysicsState, target_pos,
                    target_quat, cfg, dt):
    inv_m = jnp.asarray(ps.inv_mass)
    dyn = (inv_m > 0)[:, None]

    g = (jnp.asarray(cfg.gravity_direction, jnp.float32)
         * cfg.gravity_strength * cfg.world_scale)
    vel = state.vel + g[None, :] * dt
    vel = vel * jnp.power(1.0 - jnp.asarray(ps.lin_damp), dt)[:, None]
    omega = state.omega * jnp.power(1.0 - jnp.asarray(ps.ang_damp), dt)[:, None]

    pos0 = jnp.where(dyn, state.pos, target_pos)
    quat0 = jnp.where(dyn, state.quat, target_quat)

    pos = pos0 + jnp.where(dyn, vel * dt, 0.0)
    quat = jnp.where(dyn, _apply_small_rotation(quat0, omega * dt), quat0)

    # narrowphase once per substep (Bullet-style); iterations reuse the set
    # rotation-aware anchors are a BOX feature (a corner push that rotates
    # the body must reduce that corner's depth, or the solver spins boxes
    # up out of rest). Rigs without boxes — the common MMD hair/skirt rig,
    # all spheres/capsules — keep the cheap center-translation depth
    # updates: the per-iteration quat_rotate over every contact row
    # measured ~2x the whole r3 physics cost at crowd scale.
    rot_aware = bool((np.asarray(ps.shape) == P.SHAPE_BOX).any())
    if len(ps.pair_i):
        c_point, c_n, c_depth0 = pair_contacts(ps, pos, quat)
        if c_depth0.shape[1] == 1:
            # single-slot rigs drop the manifold axis entirely: the cache
            # is re-read every solver iteration, so it stays as the flat
            # [.., 3] rows
            c_point, c_n, c_depth0 = c_point[:, 0], c_n[:, 0], c_depth0[:, 0]
        if rot_aware:
            pi_d = jnp.asarray(ps.pair_i)
            pj_d = jnp.asarray(ps.pair_j)
            # contact anchors localized into each body: iterations
            # re-derive penetration from the anchors' CURRENT world
            # positions, so rotation-induced anchor motion is tracked.
            # (rank-agnostic: the slot axis may have been squeezed away)
            def _loc(q_b, p_b):
                if c_point.ndim == 3:
                    q_b, p_b = q_b[:, None, :], p_b[:, None, :]
                return m3.quat_rotate(m3.quat_conj(q_b), c_point - p_b)
            c_la = _loc(quat[pi_d], pos[pi_d])
            c_lb = _loc(quat[pj_d], pos[pj_d])
        else:
            c_la = c_lb = None
    else:
        z3 = jnp.zeros((0, 3), jnp.float32)
        c_point, c_n, c_depth0 = z3, z3, jnp.zeros((0,), jnp.float32)
        c_la = c_lb = z3 if rot_aware else None
    g_depth0, g_point = ground_contacts(ps, pos, quat)
    if rot_aware:
        g_l = m3.quat_rotate(m3.quat_conj(quat)[:, None, :],
                             g_point - pos[:, None, :])
        # effective contact radius per slot (depth = r_eff - feature_y):
        # 0 for box corners, r for sphere/capsule features; -1e9-masked
        # slots stay hugely negative through any motion
        g_reff = g_depth0 + g_point[..., 1]
    else:
        g_l = g_reff = None
    # keep signed depths: separated pairs must stay negative or they act as
    # phantom touching contacts the moment anything moves along the normal
    cache = (c_point, c_n, c_depth0, c_la, c_lb, g_depth0, g_point, g_l,
             g_reff)
    pos_detect = pos

    # world inverse inertia once per substep (bodies rotate by ~omega*dt
    # within a substep; the Jacobi solver is approximate at that scale
    # anyway, and the recompute was ~1/3 of each iteration's cost)
    iiw = _inv_inertia_world(ps, quat)

    def iteration(_, carry):
        pos, quat = carry
        pos, quat = _joint_pass(ps, pos, quat, dt, iiw=iiw)
        pos, quat = _contact_pass(ps, pos, quat, cfg, dt, cache,
                                  pos_detect, pos0, iiw=iiw)
        pos = jnp.where(dyn, pos, target_pos)
        quat = jnp.where(dyn, quat, target_quat)
        return pos, quat


    pos, quat = jax.lax.fori_loop(0, cfg.solver_iterations, iteration,
                                  (pos, quat))

    vel_new = (pos - pos0) / dt
    dq = m3.quat_mul(quat, m3.quat_conj(quat0))
    sign = jnp.sign(dq[..., 3:4])
    omega_new = 2.0 * dq[..., :3] * sign / dt

    # contact velocity pass (the XPBD velocity step / Bullet's split
    # impulse): (pos - pos0)/dt converts the position solve's penetration
    # push-out into outgoing velocity, which CATAPULTS deeply-corrected
    # bodies (a resting tilted capsule bounced meters high). At every
    # active contact the normal velocity AT THE CONTACT POINT is reset to
    # the restitution target max(0, -e * v_n_pre) — 0 for resting contact
    # (e = 0 or approach below threshold), an exact elastic rebound
    # otherwise. e combines multiplicatively like Bullet
    # (btManifoldResult::calculateCombinedRestitution); the 2*g*dt
    # threshold suppresses resting micro-bounce. Tangential velocity is
    # untouched (friction is positional), angular response comes from the
    # inertia-weighted impulse at the anchor.
    e_body = jnp.asarray(ps.restitution)
    g_mag = jnp.linalg.norm(g) + _EPS
    thresh = 2.0 * g_mag * dt
    (c_point, c_n, c_depth0, _, _, g_depth0, g_point, _, _) = cache
    iiw_post = _inv_inertia_world(ps, quat)

    # ground rows: FLAT [R*G] slot-minor (infinite-mass plane: direct
    # application; rank-2 rows for the same layout reason as
    # _apply_ground_correction)
    g_slots = g_depth0.shape[1]
    e_gnd = e_body * getattr(cfg, "floor_restitution", 0.0)
    r_g = g_point.reshape(-1, 3) - jnp.repeat(pos_detect, g_slots, axis=0)
    omega_r = jnp.repeat(omega, g_slots, axis=0)
    v_pre_g = jnp.repeat(vel[:, 1], g_slots) \
        + jnp.cross(omega_r, r_g)[..., 1]                     # [RG]
    e_gnd_r = jnp.repeat(e_gnd, g_slots)
    target_g = jnp.where((v_pre_g < -thresh) & (e_gnd_r > 0),
                         -e_gnd_r * v_pre_g, 0.0)
    act_g = (g_depth0.reshape(-1) > 0) & jnp.repeat(dyn[:, 0], g_slots) \
        & cfg.has_floor
    inv_act_g = jnp.repeat(1.0 / jnp.maximum(jnp.sum(
        act_g.reshape(-1, g_slots).astype(jnp.float32), 1), 1.0), g_slots)
    rxn_g = jnp.cross(r_g, jnp.broadcast_to(
        jnp.asarray([0.0, 1.0, 0.0], jnp.float32), r_g.shape))
    iiw_r = jnp.repeat(iiw_post, g_slots, axis=0)
    im_r = jnp.repeat(inv_m, g_slots)
    w_g = im_r + jnp.einsum("ki,kij,kj->k", rxn_g, iiw_r, rxn_g)

    def ground_vel_iter(_, vw):
        v, w = vw
        v_n = jnp.repeat(v[:, 1], g_slots) \
            + jnp.cross(jnp.repeat(w, g_slots, axis=0), r_g)[..., 1]
        dvn = jnp.where(act_g, (target_g - v_n) * inv_act_g, 0.0)
        lam = dvn / jnp.maximum(w_g, _EPS)                    # [RG]
        v = v.at[:, 1].add(lam.reshape(-1, g_slots).sum(1) * inv_m)
        dw = jnp.einsum("kij,kj->ki", iiw_post,
                        (rxn_g * lam[..., None]).reshape(-1, g_slots,
                                                         3).sum(1))
        return v, w + dw

    vel_new, omega_new = jax.lax.fori_loop(0, VELOCITY_PASS_ITERS,
                                           ground_vel_iter,
                                           (vel_new, omega_new))

    if len(ps.pair_i):
        multi = c_depth0.ndim == 2
        if multi:
            m_slots = c_depth0.shape[1]
            i = jnp.tile(jnp.asarray(ps.pair_i), m_slots)
            j = jnp.tile(jnp.asarray(ps.pair_j), m_slots)
            n_f = jnp.transpose(c_n, (1, 0, 2)).reshape(-1, 3)
            p_f = jnp.transpose(c_point, (1, 0, 2)).reshape(-1, 3)
            d0_f = c_depth0.T.reshape(-1)
            inv_act = jnp.tile(1.0 / jnp.maximum(
                jnp.sum((c_depth0 > 0).astype(jnp.float32), 1), 1.0),
                m_slots)
            scat = (jnp.tile(jnp.asarray(ps.s_pair_a), (1, m_slots)),
                    jnp.tile(jnp.asarray(ps.s_pair_b), (1, m_slots)))
        else:
            i = jnp.asarray(ps.pair_i)
            j = jnp.asarray(ps.pair_j)
            n_f, p_f, d0_f = c_n, c_point, c_depth0
            inv_act = 1.0
            scat = (jnp.asarray(ps.s_pair_a), jnp.asarray(ps.s_pair_b))
        r_a = p_f - pos_detect[i]
        r_b = p_f - pos_detect[j]
        e_pair = e_body[i] * e_body[j]
        v_pre = jnp.sum(n_f * ((vel[i] + jnp.cross(omega[i], r_a))
                               - (vel[j] + jnp.cross(omega[j], r_b))), -1)
        target = jnp.where((v_pre < -thresh) & (e_pair > 0),
                           -e_pair * v_pre, 0.0)
        act = d0_f > 0

        def pair_vel_iter(_, vw):
            v, w = vw
            v_n = jnp.sum(n_f * ((v[i] + jnp.cross(w[i], r_a))
                                 - (v[j] + jnp.cross(w[j], r_b))), -1)
            dvn = jnp.where(act, (target - v_n) * inv_act, 0.0)
            return _apply_velocity_corrections(ps, v, w, i, j, n_f, dvn,
                                               r_a, r_b, scat, iiw_post)

        vel_new, omega_new = jax.lax.fori_loop(0, VELOCITY_PASS_ITERS,
                                               pair_vel_iter,
                                               (vel_new, omega_new))

    vel = jnp.where(dyn, vel_new, 0.0)
    omega = jnp.where(dyn, omega_new, 0.0)
    return PhysicsState(pos=pos, quat=quat, vel=vel, omega=omega)


def physics_react(static: ModelStatic, ps: PhysicsStatic, state: PhysicsState,
                  pose: PoseArrays, cfg) -> tuple[PhysicsState, PoseArrays]:
    """Full React(step): substeps at substep_hz, then Synchronize + Fix
    write-back into the pose (mmd-bullet_impl.inl:312-326)."""
    if ps.n_bodies == 0:
        return state, pose
    target_pos, target_quat = body_targets(ps, pose)
    sub_dt = 1.0 / cfg.substep_hz
    # stepSimulation(step, 60): substep count capped at max_substeps
    # (mmd-bullet_impl.inl:313)
    n_sub = min(max(1, round(cfg.dt * cfg.substep_hz)), cfg.max_substeps)
    state = jax.lax.fori_loop(
        0, n_sub,
        lambda _, s: physics_substep(ps, s, target_pos, target_quat, cfg,
                                     sub_dt),
        state)

    # Synchronize: skin[bone] = W_body @ rest_frame^-1 for dynamic non-ghost.
    # Scatter ONLY the writeback subset (host-static indices): scattering all
    # rows would write duplicate bone indices (multiple bodies per bone,
    # boneless bodies aliased to 0) with undefined XLA set-order. The
    # writeback set holds at most one body per bone by construction.
    wb_idx = np.nonzero(ps.writeback)[0]
    if len(wb_idx):
        rot = m3.quat_to_mat3(m3.quat_mul(
            state.quat[wb_idx],
            m3.quat_conj(jnp.asarray(ps.rest_quat[wb_idx]))))
        trans = state.pos[wb_idx] - jnp.einsum(
            "rij,rj->ri", rot, jnp.asarray(ps.rest_pos[wb_idx]))
        skin_new = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32),
                                    rot.shape[:1] + (4, 4))
        skin_new = skin_new.at[:, :3, :3].set(rot).at[:, :3, 3].set(trans)
        pose = pose.replace(
            skin=pose.skin.at[jnp.asarray(ps.bone[wb_idx])].set(skin_new))

    # Fix: strict bodies re-pin the bone translation (mmd-bullet_impl.inl:42-56)
    strict_ids = [i for i in range(ps.n_bodies)
                  if ps.strict[i] and ps.writeback[i]]
    for i in strict_ids:
        bone = int(ps.bone[i])
        rest = jnp.asarray(static.bone_rest[bone])
        parent = int(static.bone_parent[bone])
        skin_b = pose.skin[bone]
        local = skin_b.at[:3, 3].add(skin_b[:3, :3] @ rest)  # skin @ T(rest)
        if parent >= 0:
            pw = pose.world[parent]
            local = jnp.linalg.inv(pw) @ local
        local = local.at[:3, 3].set(
            pose.total_trans[bone] + jnp.asarray(static.local_offset[bone]))
        world_b = (pose.world[parent] @ local) if parent >= 0 else local
        skin_fixed = world_b.at[:3, 3].add(-world_b[:3, :3] @ rest)
        pose = pose.replace(
            world=pose.world.at[bone].set(world_b),
            skin=pose.skin.at[bone].set(skin_fixed))
    return state, pose
