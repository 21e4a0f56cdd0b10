import numpy as np
import jax
import jax.numpy as jnp
import pytest

from simple_mmd_renderer.formats import pmx as P
from simple_mmd_renderer.core import model as M
from simple_mmd_renderer.core import pose as PO
from simple_mmd_renderer.utils import math3d as m3

from fixtures import two_bone_arm, ik_leg
from oracle_poser import OraclePoser


def run_jax(static, anim_rot, anim_trans, morph_rates):
    pose = PO.pre_physics_posing(static, jnp.asarray(anim_rot),
                                 jnp.asarray(anim_trans),
                                 jnp.asarray(morph_rates))
    pose = PO.post_physics_posing(static, pose, jnp.asarray(anim_rot),
                                  jnp.asarray(anim_trans),
                                  jnp.asarray(morph_rates))
    return pose


def run_oracle(pm, anim_rot, anim_trans, morph_rates):
    o = OraclePoser(pm)
    for i in range(o.B):
        o.set_bone_pose(i, anim_trans[i], anim_rot[i])
    for i in range(o.n_morphs):
        o.set_morph(i, float(morph_rates[i]))
    o.pre_physics()
    o.post_physics()
    return o


def neutral_inputs(static):
    b = static.n_bones
    rot = np.tile(np.array([0, 0, 0, 1], np.float32), (b, 1))
    trans = np.zeros((b, 3), np.float32)
    rates = np.zeros(static.n_morphs, np.float32)
    return rot, trans, rates


def test_rest_pose_identity():
    pm = two_bone_arm()
    static = M.build_model(pm)
    rot, trans, rates = neutral_inputs(static)
    pose = run_jax(static, rot, trans, rates)
    # at rest, world = T(rest), skin = identity
    np.testing.assert_allclose(pose.world[1][:3, 3], static.bone_rest[1], atol=1e-6)
    np.testing.assert_allclose(pose.skin,
                               np.tile(np.eye(4), (static.n_bones, 1, 1)), atol=1e-6)
    p, n = PO.deform(static, pose)
    np.testing.assert_allclose(p, static.positions, atol=1e-6)
    np.testing.assert_allclose(n, static.normals, atol=1e-6)


def test_fk_rotation_matches_oracle():
    pm = two_bone_arm()
    static = M.build_model(pm)
    rot, trans, rates = neutral_inputs(static)
    # rotate root 90° about z, translate child
    rot[0] = [0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)]
    trans[1] = [0.0, 0.5, 0.0]
    rot[1] = [np.sin(0.2), 0, 0, np.cos(0.2)]

    pose = run_jax(static, rot, trans, rates)
    o = run_oracle(pm, rot, trans, rates)

    np.testing.assert_allclose(pose.world, o.world, atol=1e-5)
    np.testing.assert_allclose(pose.skin, o.skin, atol=1e-5)

    pj, nj = PO.deform(static, pose)
    po, no = o.deform()
    np.testing.assert_allclose(pj, po, atol=1e-5)
    np.testing.assert_allclose(nj, no, atol=1e-5)


def test_morphs_match_oracle():
    pm = two_bone_arm()
    static = M.build_model(pm)
    rot, trans, rates = neutral_inputs(static)
    rates[0] = 0.8   # vertex morph
    rates[1] = 0.6   # bone morph
    rates[2] = 1.0   # group morph -> vertex morph at 0.5

    pose = run_jax(static, rot, trans, rates)
    o = run_oracle(pm, rot, trans, rates)

    np.testing.assert_allclose(pose.vertex_offsets, o.vertex_offsets, atol=1e-6)
    np.testing.assert_allclose(pose.world, o.world, atol=1e-5)
    pj, _ = PO.deform(static, pose)
    po, _ = o.deform()
    np.testing.assert_allclose(pj, po, atol=1e-5)


def _make_append_rig():
    """root -> a; b appends rotation from a at ratio 0.5."""
    pm = two_bone_arm()
    b = P.Bone("append", "append", np.array([2, 0, 0], np.float32), 0, 1,
               P.BONE_ROTATABLE | P.BONE_VISIBLE | P.BONE_APPEND_ROTATE
               | P.BONE_APPEND_TRANSLATE)
    b.child_offset = np.zeros(3, np.float32)
    b.append_parent = 1
    b.append_ratio = 0.5
    pm.bones.append(b)
    return pm


def test_append_bone_matches_oracle():
    pm = _make_append_rig()
    static = M.build_model(pm)
    rot, trans, rates = neutral_inputs(static)
    rot[1] = [0, np.sin(0.4), 0, np.cos(0.4)]
    trans[1] = [0.1, 0.2, 0.0]
    rot[2] = [np.sin(0.1), 0, 0, np.cos(0.1)]

    pose = run_jax(static, rot, trans, rates)
    o = run_oracle(pm, rot, trans, rates)
    np.testing.assert_allclose(pose.total_rot, o.total_rot, atol=1e-5)
    np.testing.assert_allclose(pose.total_trans, o.total_trans, atol=1e-5)
    np.testing.assert_allclose(pose.world, o.world, atol=1e-5)


@pytest.mark.parametrize("target", [
    (0.0, 1.0, 0.5), (0.5, 2.0, 0.0), (0.0, 0.2, -1.0), (0.0, 4.5, 0.0)])
def test_ccd_ik_matches_oracle(target):
    pm = ik_leg()
    static = M.build_model(pm)
    rot, trans, rates = neutral_inputs(static)
    # move the IK goal bone; ankle chases it through knee/hip links
    trans[4] = np.asarray(target, np.float32) - static.bone_rest[4]

    pose = run_jax(static, rot, trans, rates)
    o = run_oracle(pm, rot, trans, rates)
    # Converged CCD amplifies float drift (many joint configs satisfy the
    # goal); the tight semantic comparison is test_ccd_ik_few_iterations.
    np.testing.assert_allclose(pose.world, o.world, atol=5e-3)
    np.testing.assert_allclose(pose.skin, o.skin, atol=5e-3)
    # the chain actually reaches (when the goal is reachable)
    goal = np.asarray(target)
    reach = np.linalg.norm(goal - static.bone_rest[1])
    if reach < 3.9:  # leg length 4 with knee limit, leave slack
        ankle = np.asarray(pose.world[3][:3, 3])
        assert np.linalg.norm(ankle - goal) < 0.15


@pytest.mark.parametrize("target", [
    (0.0, 1.0, 0.5), (0.5, 2.0, 0.0), (0.0, 0.2, -1.0), (1.0, 3.0, 1.0)])
def test_ccd_ik_few_iterations(target):
    """4 CCD iterations (below convergence): float drift cannot amplify, so
    the JAX solve must match the sequential oracle almost exactly."""
    pm = ik_leg()
    pm.bones[4].ik_loop = 4
    static = M.build_model(pm)
    rot, trans, rates = neutral_inputs(static)
    trans[4] = np.asarray(target, np.float32) - static.bone_rest[4]
    pose = run_jax(static, rot, trans, rates)
    o = run_oracle(pm, rot, trans, rates)
    np.testing.assert_allclose(pose.world, o.world, atol=1e-4)
    np.testing.assert_allclose(pose.ik_rot, o.ik_rot, atol=1e-4)


def test_ik_respects_knee_limit():
    pm = ik_leg()
    static = M.build_model(pm)
    rot, trans, rates = neutral_inputs(static)
    trans[4] = np.array([0.0, 2.0, 0.0], np.float32)  # fold the leg
    pose = run_jax(static, rot, trans, rates)
    # knee local rotation must stay a pure negative-x rotation
    knee_local = m3.quat_mul(pose.ik_rot[2], pose.pre_ik_rot[2])
    e = np.asarray(m3.quat_to_euler(knee_local, "xyz"))
    assert e[0] <= -0.008726  # hi limit
    assert e[0] >= -np.pi - 1e-5
    assert abs(e[1]) < 1e-4 and abs(e[2]) < 1e-4


def test_post_physics_partition():
    pm = two_bone_arm()
    pm.bones[1].flags |= P.BONE_POST_PHYSICS
    static = M.build_model(pm)
    assert [s.kind for s in static.post_segments] == ["fk"]
    rot, trans, rates = neutral_inputs(static)
    rot[0] = [0, 0, np.sin(0.3), np.cos(0.3)]
    rot[1] = [np.sin(0.2), 0, 0, np.cos(0.2)]
    pose = run_jax(static, rot, trans, rates)
    o = run_oracle(pm, rot, trans, rates)
    np.testing.assert_allclose(pose.world, o.world, atol=1e-5)
    np.testing.assert_allclose(pose.skin, o.skin, atol=1e-5)


def test_pipeline_jits_and_vmaps():
    pm = ik_leg()
    static = M.build_model(pm)
    rot, trans, rates = neutral_inputs(static)

    @jax.jit
    def step(r, t, m):
        pose = PO.pre_physics_posing(static, r, t, m)
        pose = PO.post_physics_posing(static, pose, r, t, m)
        return pose.skin

    single = step(jnp.asarray(rot), jnp.asarray(trans), jnp.asarray(rates))

    batch_t = np.tile(trans, (4, 1, 1))
    batch_t[:, 4, 1] = np.linspace(-2, 1, 4)
    batched = jax.jit(jax.vmap(step, in_axes=(None, 0, None)))(
        jnp.asarray(rot), jnp.asarray(batch_t), jnp.asarray(rates))
    assert batched.shape == (4, static.n_bones, 4, 4)
    np.testing.assert_allclose(
        batched[np.argmin(np.abs(np.linspace(-2, 1, 4)))],
        single, atol=1e-4)


def test_matmul_skinning_matches_gather():
    pm = two_bone_arm()
    static = M.build_model(pm)
    assert static.skin_weight_dense is not None
    rot, trans, rates = neutral_inputs(static)
    rot[0] = [0, 0, np.sin(0.4), np.cos(0.4)]
    trans[1] = [0.2, 0.1, 0.0]
    rates[0] = 0.7
    pose = run_jax(static, rot, trans, rates)
    p_mm, n_mm = PO.deform(static, pose, use_matmul=True)
    p_g, n_g = PO.deform(static, pose, use_matmul=False)
    np.testing.assert_allclose(np.asarray(p_mm), np.asarray(p_g), atol=1e-5)
    np.testing.assert_allclose(np.asarray(n_mm), np.asarray(n_g), atol=1e-5)


def test_matmul_skinning_bf16_weights_close():
    """Opt-in bf16 weight table (halved HBM footprint/traffic): weights
    round at ~2^-9 relative but the blend still accumulates in f32, so
    deformed positions stay within bf16 weight quantization of the exact
    gather path (ops/skinning.py docstring contract)."""
    import dataclasses

    import jax.numpy as jnp
    from simple_mmd_renderer.ops.skinning import build_weight_matrix

    pm = two_bone_arm()
    static = M.build_model(pm)
    w16 = build_weight_matrix(static.skin_bones, static.skin_weights,
                              static.n_bones, dtype=jnp.bfloat16)
    assert jnp.asarray(w16).dtype == jnp.bfloat16
    static16 = dataclasses.replace(static, skin_weight_dense=w16)
    rot, trans, rates = neutral_inputs(static)
    rot[0] = [0, 0, np.sin(0.4), np.cos(0.4)]
    trans[1] = [0.2, 0.1, 0.0]
    pose = run_jax(static, rot, trans, rates)
    p16, n16 = PO.deform(static16, pose, use_matmul=True)
    p_g, n_g = PO.deform(static, pose, use_matmul=False)
    # bound: |dp| <= sum_k |dw_k| * |M_k p| ~ 2^-9 * coordinate scale
    scale = np.abs(np.asarray(p_g)).max() + 1.0
    np.testing.assert_allclose(np.asarray(p16), np.asarray(p_g),
                               atol=2 ** -8 * scale)
    np.testing.assert_allclose(np.asarray(n16), np.asarray(n_g),
                               atol=2 ** -8 * 2.0)


def test_skinning_bitwise_stable():
    """BASELINE.md: skinning must be bitwise-stable — identical inputs give
    bit-identical outputs across separate jitted executions."""
    pm = two_bone_arm()
    static = M.build_model(pm)
    rot, trans, rates = neutral_inputs(static)
    rot[1] = [np.sin(0.3), 0, 0, np.cos(0.3)]

    @jax.jit
    def run(r, t, m):
        pose = PO.pre_physics_posing(static, r, t, m)
        pose = PO.post_physics_posing(static, pose, r, t, m)
        return PO.deform(static, pose)[0]

    a = np.asarray(run(jnp.asarray(rot), jnp.asarray(trans), jnp.asarray(rates)))
    b = np.asarray(run(jnp.asarray(rot), jnp.asarray(trans), jnp.asarray(rates)))
    np.testing.assert_array_equal(a, b)


def _sdef_arm():
    """two_bone_arm with non-trivial SDEF auxiliary points."""
    pm = two_bone_arm()
    pm.sdef_r0[3] = [0.8, 0.1, 0.0]
    pm.sdef_r1[3] = [1.2, -0.1, 0.0]
    return pm


def test_sdef_true_identity_pose_is_rest():
    pm = _sdef_arm()
    static = M.build_model(pm)
    assert (static.skin_type == P.SDEF).sum() == 1
    rot, trans, rates = neutral_inputs(static)
    pose = run_jax(static, rot, trans, rates)
    p, n = PO.deform(static, pose, sdef=True)
    np.testing.assert_allclose(p, static.positions, atol=1e-6)
    np.testing.assert_allclose(n, static.normals, atol=1e-6)


def test_sdef_true_rigid_motion_equivariant():
    """Rotating the root rotates the whole rig rigidly: true SDEF must map
    every vertex by exactly that rotation (w0*cr0 + w1*cr1 == C identity)."""
    pm = _sdef_arm()
    static = M.build_model(pm)
    rot, trans, rates = neutral_inputs(static)
    ang = 0.7
    rot[0] = [0, 0, np.sin(ang / 2), np.cos(ang / 2)]
    trans[0] = [0.3, -0.2, 0.5]
    pose = run_jax(static, rot, trans, rates)
    p, n = PO.deform(static, pose, sdef=True)
    c, s = np.cos(ang), np.sin(ang)
    rmat = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    exp_p = static.positions @ rmat.T + trans[0]
    exp_n = static.normals @ rmat.T
    np.testing.assert_allclose(p, exp_p, atol=1e-5)
    np.testing.assert_allclose(n, exp_n, atol=1e-5)


def test_sdef_true_differs_from_fallback_at_bent_joint():
    """At a bent joint the spherical blend must separate from the linear
    matrix-lerp fallback (which collapses the skin), while non-SDEF
    vertices stay bit-identical."""
    pm = _sdef_arm()
    static = M.build_model(pm)
    rot, trans, rates = neutral_inputs(static)
    rot[1] = [0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)]  # bend child 90°
    pose = run_jax(static, rot, trans, rates)
    p_fb, n_fb = PO.deform(static, pose, sdef=False)
    p_tr, n_tr = PO.deform(static, pose, sdef=True)
    assert np.abs(np.asarray(p_tr[3]) - np.asarray(p_fb[3])).max() > 1e-3
    np.testing.assert_allclose(p_tr[:3], p_fb[:3], atol=0)
    # the spherical blend preserves distance to the rotation center better:
    # |p' - C'| should stay near the rest distance |p - C| under pure
    # rotation blending (translation part cancels through the cr anchors)
    nrm_len = np.linalg.norm(np.asarray(n_tr[3]))
    np.testing.assert_allclose(nrm_len, 1.0, atol=1e-5)
