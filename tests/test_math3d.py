import numpy as np
import jax.numpy as jnp
import pytest

from simple_mmd_renderer.utils import math3d as m3


def rand_quat(rng, n=()):
    q = rng.standard_normal(n + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quat_mul_matches_matrix_product():
    rng = np.random.default_rng(0)
    a, b = rand_quat(rng, (16,)), rand_quat(rng, (16,))
    left = m3.quat_to_mat3(m3.quat_mul(a, b))
    right = jnp.einsum("nij,njk->nik", m3.quat_to_mat3(a), m3.quat_to_mat3(b))
    np.testing.assert_allclose(left, right, atol=1e-5)


def test_quat_rotate_matches_mat3():
    rng = np.random.default_rng(1)
    q = rand_quat(rng, (8,))
    v = rng.standard_normal((8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        m3.quat_rotate(q, v),
        jnp.einsum("nij,nj->ni", m3.quat_to_mat3(q), v),
        atol=1e-5,
    )


def test_axis_angle():
    axis = jnp.array([0.0, 0.0, 2.0])  # unnormalized on purpose
    q = m3.axis_angle_to_quat(axis, jnp.array(np.pi / 2, jnp.float32))
    v = m3.quat_rotate(q, jnp.array([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(v, [0.0, 1.0, 0.0], atol=1e-6)
    # zero axis -> identity
    q0 = m3.axis_angle_to_quat(jnp.zeros(3), jnp.array(1.0, jnp.float32))
    np.testing.assert_allclose(q0, [0, 0, 0, 1], atol=1e-7)


@pytest.mark.parametrize("order", ["xyz", "xzy", "yxz", "yzx", "zxy", "zyx"])
def test_euler_roundtrip_and_composition(order):
    rng = np.random.default_rng(hash(order) % 2**31)
    # small angles stay inside the principal branch of every order
    e = (rng.uniform(-1.0, 1.0, (32, 3))).astype(np.float32)
    q = m3.euler_to_quat(jnp.asarray(e), order)
    e2 = m3.quat_to_euler(q, order)
    np.testing.assert_allclose(e2, e, atol=1e-5)

    # euler_to_quat(order) must equal composing single-axis rotations in that
    # order (applied left-to-right as active rotations: q = q_a ⊗ q_b ⊗ q_c
    # where `order`="abc").
    axes = {"x": np.array([1.0, 0, 0]), "y": np.array([0, 1.0, 0]), "z": np.array([0, 0, 1.0])}
    for row in e[:4]:
        comp = None
        angles = {"x": row[0], "y": row[1], "z": row[2]}
        for axis_name in order:
            qa = m3.axis_angle_to_quat(
                jnp.asarray(axes[axis_name], jnp.float32),
                jnp.asarray(angles[axis_name], jnp.float32),
            )
            comp = qa if comp is None else m3.quat_mul(comp, qa)
        qref = m3.euler_to_quat(jnp.asarray(row), order)
        sign = np.sign(float(jnp.sum(comp * qref)))
        np.testing.assert_allclose(sign * comp, qref, atol=1e-5)


def test_nlerp_sign_flip():
    rng = np.random.default_rng(3)
    a = rand_quat(rng, ())
    b = -a  # antipodal: nlerp must flip and return ~a direction
    out = m3.quat_nlerp(jnp.asarray(a), jnp.asarray(b), 0.5)
    np.testing.assert_allclose(np.abs(np.dot(np.asarray(out), a)), 1.0, atol=1e-5)


def test_slerp_endpoints_and_midpoint():
    a = m3.quat_identity()
    b = m3.axis_angle_to_quat(jnp.array([0.0, 1.0, 0.0]), jnp.array(1.0, jnp.float32))
    np.testing.assert_allclose(m3.quat_slerp(a, b, 0.0), a, atol=1e-6)
    np.testing.assert_allclose(m3.quat_slerp(a, b, 1.0), b, atol=1e-6)
    mid = m3.quat_slerp(a, b, 0.5)
    expect = m3.axis_angle_to_quat(jnp.array([0.0, 1.0, 0.0]), jnp.array(0.5, jnp.float32))
    np.testing.assert_allclose(mid, expect, atol=1e-6)


def test_affine_roundtrip():
    rng = np.random.default_rng(4)
    q = rand_quat(rng, (5,))
    t = rng.standard_normal((5, 3)).astype(np.float32)
    m = m3.mat_from_quat_trans(jnp.asarray(q), jnp.asarray(t))
    p = rng.standard_normal((5, 3)).astype(np.float32)
    p2 = m3.transform_point(m, jnp.asarray(p))
    p3 = m3.transform_point(m3.affine_inverse(m), p2)
    np.testing.assert_allclose(p3, p, atol=1e-4)


def test_lerp_eps_shortcuts():
    a = jnp.array([1.0, 2.0, 3.0])
    b = jnp.array([4.0, 5.0, 6.0])
    np.testing.assert_array_equal(m3.lerp(a, b, 0.0), a)
    np.testing.assert_array_equal(m3.lerp(a, b, 1.0), b)
    np.testing.assert_allclose(m3.lerp(a, b, 0.5), [2.5, 3.5, 4.5])


def test_mat3_to_quat_near_180deg():
    """The w-only trace branch is degenerate near 180 deg (trace ~ -1); the
    4-branch conversion must roundtrip such rotations (ADVICE r2: the SDEF
    path feeds raw skinning matrices that can reach them)."""
    rng = np.random.default_rng(7)
    ax = rng.standard_normal((32, 3))
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    ang = np.float32(np.pi) - rng.uniform(0.0, 1e-4, 32).astype(np.float32)
    q = np.concatenate([ax * np.sin(ang[:, None] / 2),
                        np.cos(ang / 2)[:, None]], -1).astype(np.float32)
    m = m3.quat_to_mat3(jnp.asarray(q))
    m2 = m3.quat_to_mat3(m3.mat3_to_quat(m))
    np.testing.assert_allclose(np.asarray(m2), np.asarray(m), atol=1e-5)
