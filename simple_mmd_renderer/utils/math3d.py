"""3D math core: Hamilton quaternions (x, y, z, w), column-vector 4x4 affines.

Semantics mirror the reference engine's math layer (libmmd `util/math.inl` /
`util/math_impl.inl`) after the row->column convention flip documented in
docs/CONVENTIONS.md. All functions are pure jnp and batch over leading axes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

EPS = 1e-8  # mmd_math_const_eps in the reference (mmd.hxx)


def f32_matmul(fn):
    """Trace `fn` with float32 matrix products: on a GPU the default lets a
    float32 dot run in TF32 (~3 significant digits), which moves skinned
    vertices, clip coordinates and physics state by visible amounts. The
    sim step and the frame renderers are wrapped, so every product that
    places geometry or integrates state is exact float32."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)
    return wrapped


# ---------------------------------------------------------------------------
# Quaternions — (..., 4) arrays, (x, y, z, w)
# ---------------------------------------------------------------------------

def quat_identity(shape=()):
    q = jnp.zeros(shape + (4,), jnp.float32)
    return q.at[..., 3].set(1.0)


def quat_mul(a, b):
    """Hamilton product a ⊗ b; R(a⊗b) = R(a) @ R(b).

    Matches the reference quaternion `operator*` (math_impl.inl:510-517).
    """
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
            aw * bw - (ax * bx + ay * by + az * bz),
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.asarray([-1.0, -1.0, -1.0, 1.0], q.dtype)


def quat_normalize(q):
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return jnp.where(n > EPS, q / jnp.maximum(n, EPS), q)


def quat_to_mat3(q):
    """Column-convention rotation matrix; transpose of libmmd ToRotateMatrix
    (math_impl.inl:540-563)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, zx = x * y, y * z, z * x
    wx, wy, wz = w * x, w * y, w * z
    one = jnp.ones_like(x)
    m = jnp.stack(
        [
            one - 2 * (yy + zz), 2 * (xy - wz), 2 * (zx + wy),
            2 * (xy + wz), one - 2 * (zz + xx), 2 * (yz - wx),
            2 * (zx - wy), 2 * (yz + wx), one - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis, angle):
    """Quaternion from (possibly unnormalized) axis + angle.

    Mirrors AxisToQuaternion (math_impl.inl:1047-1057): divides by the axis
    norm; identity when the norm is ~0.
    """
    norm = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    half = angle[..., None] * 0.5
    xyz = (jnp.sin(half) / jnp.maximum(norm, EPS)) * axis
    w = jnp.cos(half) * jnp.ones_like(norm)
    q = jnp.concatenate([xyz, w], axis=-1)
    return jnp.where(norm > EPS, q, quat_identity(q.shape[:-1]))


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion q."""
    qv = q[..., :3]
    t = 2.0 * jnp.cross(qv, v)
    return v + q[..., 3:4] * t + jnp.cross(qv, t)


# --- Euler conversions (six orders, libmmd math_impl.inl:1059-1258) --------

def _q_terms(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return dict(
        xx=x * x, yy=y * y, zz=z * z,
        wx=w * x, wy=w * y, wz=w * z,
        xy=x * y, zx=z * x, yz=y * z,
    )


def _asin_safe(v):
    return jnp.arcsin(jnp.clip(v, -1.0, 1.0))


def quat_to_euler(q, order):
    t = _q_terms(q)
    at2, asn = jnp.arctan2, _asin_safe
    if order == "xyz":
        e = (at2(2 * (t["wx"] - t["yz"]), 1 - 2 * (t["xx"] + t["yy"])),
             asn(2 * (t["wy"] + t["zx"])),
             at2(2 * (t["wz"] - t["xy"]), 1 - 2 * (t["yy"] + t["zz"])))
    elif order == "xzy":
        e = (at2(2 * (t["wx"] + t["yz"]), 1 - 2 * (t["xx"] + t["zz"])),
             at2(2 * (t["wy"] + t["zx"]), 1 - 2 * (t["yy"] + t["zz"])),
             asn(2 * (t["wz"] - t["xy"])))
    elif order == "yxz":
        e = (asn(2 * (t["wx"] - t["yz"])),
             at2(2 * (t["wy"] + t["zx"]), 1 - 2 * (t["xx"] + t["yy"])),
             at2(2 * (t["wz"] + t["xy"]), 1 - 2 * (t["xx"] + t["zz"])))
    elif order == "yzx":
        e = (at2(2 * (t["wx"] - t["yz"]), 1 - 2 * (t["xx"] + t["zz"])),
             at2(2 * (t["wy"] - t["zx"]), 1 - 2 * (t["yy"] + t["zz"])),
             asn(2 * (t["wz"] + t["xy"])))
    elif order == "zxy":
        e = (asn(2 * (t["wx"] + t["yz"])),
             at2(2 * (t["wy"] - t["zx"]), 1 - 2 * (t["xx"] + t["yy"])),
             at2(2 * (t["wz"] - t["xy"]), 1 - 2 * (t["xx"] + t["zz"])))
    elif order == "zyx":
        e = (at2(2 * (t["wx"] + t["yz"]), 1 - 2 * (t["xx"] + t["yy"])),
             asn(2 * (t["wy"] - t["zx"])),
             at2(2 * (t["wz"] + t["xy"]), 1 - 2 * (t["yy"] + t["zz"])))
    else:
        raise ValueError(f"unknown euler order {order!r}")
    return jnp.stack(e, axis=-1)


def euler_to_quat(euler, order):
    cx = jnp.cos(euler[..., 0] * 0.5)
    sx = jnp.sin(euler[..., 0] * 0.5)
    cy = jnp.cos(euler[..., 1] * 0.5)
    sy = jnp.sin(euler[..., 1] * 0.5)
    cz = jnp.cos(euler[..., 2] * 0.5)
    sz = jnp.sin(euler[..., 2] * 0.5)
    if order == "xyz":
        q = (sx * cy * cz + cx * sy * sz, cx * sy * cz - sx * cy * sz,
             sx * sy * cz + cx * cy * sz, cx * cy * cz - sx * sy * sz)
    elif order == "xzy":
        q = (sx * cy * cz - cx * sy * sz, cx * sy * cz - sx * cy * sz,
             cx * cy * sz + sx * sy * cz, cx * cy * cz + sx * sy * sz)
    elif order == "yxz":
        q = (sx * cy * cz + cx * sy * sz, cx * sy * cz - sx * cy * sz,
             cx * cy * sz - sx * sy * cz, cx * cy * cz + sx * sy * sz)
    elif order == "yzx":
        q = (sx * cy * cz + cx * sy * sz, cx * sy * cz + sx * cy * sz,
             cx * cy * sz - sx * sy * cz, cx * cy * cz - sx * sy * sz)
    elif order == "zxy":
        q = (sx * cy * cz - cx * sy * sz, cx * sy * cz + sx * cy * sz,
             cx * cy * sz + sx * sy * cz, cx * cy * cz - sx * sy * sz)
    elif order == "zyx":
        q = (sx * cy * cz - cx * sy * sz, cx * sy * cz + sx * cy * sz,
             cx * cy * sz - sx * sy * cz, cx * cy * cz + sx * sy * sz)
    else:
        raise ValueError(f"unknown euler order {order!r}")
    return jnp.stack(q, axis=-1)


# --- Interpolation (libmmd Lerp/NLerp/SLerp proxies, math_impl.inl:1260-1348)

def lerp(a, b, t):
    """Linear interpolation with the reference's eps endpoint shortcuts."""
    t = jnp.asarray(t)
    tt = t[..., None] if jnp.ndim(t) < jnp.ndim(a) else t
    out = (1.0 - tt) * a + tt * b
    out = jnp.where(tt < EPS, a, out)
    return jnp.where(tt > 1.0 - EPS, b, out)


def quat_nlerp(a, b, t):
    """Normalized lerp with shortest-path sign flip (NLerpProxy)."""
    t = jnp.asarray(t)[..., None]
    dot = jnp.sum(a * b, axis=-1, keepdims=True)
    bb = jnp.where(dot < 0, -b, b)
    raw = (1.0 - t) * a + t * bb
    out = quat_normalize(raw)
    out = jnp.where(t < EPS, a, out)
    return jnp.where(t > 1.0 - EPS, b, out)


def quat_slerp(a, b, t):
    """Spherical lerp (SLerpProxy<Quaternion> specialization)."""
    t = jnp.asarray(t)[..., None]
    comega = jnp.sum(a * b, axis=-1, keepdims=True)
    flip = comega < 0
    comega = jnp.abs(comega)
    omega = jnp.arccos(jnp.clip(comega, -1.0, 1.0))
    small = omega <= EPS
    somega = jnp.sin(jnp.where(small, 1.0, omega))
    p = jnp.sin((1.0 - t) * omega) / somega
    l = jnp.sin(t * omega) / somega
    l = jnp.where(flip, -l, l)
    return jnp.where(small, a, a * p + b * l)


# ---------------------------------------------------------------------------
# 4x4 affines — column convention, p' = M @ p
# ---------------------------------------------------------------------------

def affine(rot3=None, trans=None, dtype=jnp.float32):
    """Build 4x4 from 3x3 rotation block and/or translation (batched)."""
    if rot3 is not None:
        batch = rot3.shape[:-2]
        dtype = rot3.dtype
    elif trans is not None:
        batch = trans.shape[:-1]
        dtype = trans.dtype
    else:
        batch = ()
    m = jnp.broadcast_to(jnp.eye(4, dtype=dtype), batch + (4, 4))
    if rot3 is not None:
        m = m.at[..., :3, :3].set(rot3)
    if trans is not None:
        m = m.at[..., :3, 3].set(trans)
    return m


def transform_point(m, p):
    """Apply 4x4 affine to 3-point(s)."""
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]


def rotate_vec(m, v):
    """Apply the rotation block of a 4x4 affine to vector(s)."""
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], v)


def affine_inverse(m):
    """Inverse of a rigid/affine transform via full inverse of the 3x3 block."""
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    r_inv = jnp.linalg.inv(r)
    t_inv = -jnp.einsum("...ij,...j->...i", r_inv, t)
    return affine(r_inv, t_inv)


def mat_from_quat_trans(q, t):
    return affine(quat_to_mat3(q), t)


def mat3_to_quat(m):
    """Rotation matrix [..., 3, 3] -> quaternion (x, y, z, w).

    Branchless form of the standard 4-branch (largest of trace / diagonal)
    conversion: all four candidate quaternions are computed and the one with
    the largest pivot is selected, so rotations near 180 deg (trace ~ -1,
    where the w-only branch is numerically degenerate) stay stable. The
    opt-in SDEF path feeds raw skinning matrices here, which can reach such
    rotations on extreme poses."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    # pivot magnitudes: 4w^2, 4x^2, 4y^2, 4z^2 (each = 1 + signed diag combo)
    pw = 1.0 + m00 + m11 + m22
    px = 1.0 + m00 - m11 - m22
    py = 1.0 - m00 + m11 - m22
    pz = 1.0 - m00 - m11 + m22
    sw = jnp.sqrt(jnp.maximum(pw, 1e-12))
    sx = jnp.sqrt(jnp.maximum(px, 1e-12))
    sy = jnp.sqrt(jnp.maximum(py, 1e-12))
    sz = jnp.sqrt(jnp.maximum(pz, 1e-12))
    a21 = m[..., 2, 1] - m[..., 1, 2]
    a02 = m[..., 0, 2] - m[..., 2, 0]
    a10 = m[..., 1, 0] - m[..., 0, 1]
    s01 = m[..., 0, 1] + m[..., 1, 0]
    s02 = m[..., 0, 2] + m[..., 2, 0]
    s12 = m[..., 1, 2] + m[..., 2, 1]
    qw = jnp.stack([a21, a02, a10, sw * sw], -1) / (2.0 * sw[..., None])
    qx = jnp.stack([sx * sx, s01, s02, a21], -1) / (2.0 * sx[..., None])
    qy = jnp.stack([s01, sy * sy, s12, a02], -1) / (2.0 * sy[..., None])
    qz = jnp.stack([s02, s12, sz * sz, a10], -1) / (2.0 * sz[..., None])
    piv = jnp.stack([pw, px, py, pz], -1)
    best = jnp.argmax(piv, axis=-1)[..., None]
    q = jnp.where(best == 0, qw,
                  jnp.where(best == 1, qx, jnp.where(best == 2, qy, qz)))
    # canonical sign (w >= 0) keeps blends of nearby rotations consistent
    q = jnp.where(q[..., 3:4] < 0.0, -q, q)
    return quat_normalize(q)
