"""Posing pipeline: morph application -> bone FK (level-parallel) -> CCD IK ->
skinning matrices.

Runtime rebuild of libmmd's `Poser` (`motion/poser_impl.inl:130-461`) as pure
jnp functions over a static `ModelStatic` program. The rig topology, processing
order and IK programs are baked into the traced computation (host constants);
per-frame inputs are the sampled bone poses and morph rates, so the whole
pipeline jits once per model and vmaps over instances.

Convention notes (docs/CONVENTIONS.md): column-vector affines, Hamilton
quaternions (x,y,z,w); `world` here corresponds to the reference's
`local_matrix_` after its in-place parent multiplication, and `skin` to
`skinning_matrix_ = global_offset * local` i.e. world @ T(-rest).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import math3d as m3
from ..utils import pytree
from .model import FIX_ALL, FIX_NONE, FIX_X, FIX_Y, FIX_Z, IKProgram, ModelStatic

_EPS = 1e-8


@pytree.dataclass
class PoseArrays:
    """Mutable pose state (the reference's per-bone BoneImage fields + vertex
    morph accumulator), as arrays."""
    world: jnp.ndarray          # [B,4,4] chain matrices (local_matrix_)
    skin: jnp.ndarray           # [B,4,4] skinning matrices
    total_rot: jnp.ndarray      # [B,4]
    total_trans: jnp.ndarray    # [B,3]
    pre_ik_rot: jnp.ndarray     # [B,4]
    ik_rot: jnp.ndarray         # [B,4]
    vertex_offsets: jnp.ndarray # [N,3] vertex morph accumulator
    leaf_rates: jnp.ndarray     # [M] group-expanded morph rates (extended
                                # morph application reads these downstream)


def init_pose(static: ModelStatic) -> PoseArrays:
    b = static.n_bones
    n = len(static.positions)
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (b, 4, 4))
    return PoseArrays(
        world=eye, skin=eye,
        total_rot=m3.quat_identity((b,)),
        total_trans=jnp.zeros((b, 3), jnp.float32),
        pre_ik_rot=m3.quat_identity((b,)),
        ik_rot=m3.quat_identity((b,)),
        vertex_offsets=jnp.zeros((n, 3), jnp.float32),
        leaf_rates=jnp.zeros((static.n_morphs,), jnp.float32),
    )


# ---------------------------------------------------------------------------
# Morphs (poser_impl.inl:328-360)
# ---------------------------------------------------------------------------

def apply_morphs(static: ModelStatic, morph_rates: jnp.ndarray):
    """-> (vertex_offsets [N,3], morph_rot [B,4], morph_trans [B,3],
    leaf_rates [M]).

    Group morphs are pre-expanded into leaf rates (model.build_model); the
    reference's `rate < eps` skip is applied to the summed leaf rate.
    """
    n = len(static.positions)
    b = static.n_bones
    vertex_offsets = jnp.zeros((n, 3), jnp.float32)
    morph_rot = m3.quat_identity((b,))
    morph_trans = jnp.zeros((b, 3), jnp.float32)
    if static.n_morphs == 0:
        return vertex_offsets, morph_rot, morph_trans, jnp.zeros(
            (0,), jnp.float32)

    leaf = morph_rates @ jnp.asarray(static.morph_expand)
    leaf = jnp.where(leaf >= _EPS, leaf, 0.0)

    if len(static.vm_morph):
        rates = leaf[jnp.asarray(static.vm_morph)]
        vertex_offsets = vertex_offsets.at[jnp.asarray(static.vm_vertex)].add(
            jnp.asarray(static.vm_offset) * rates[:, None])

    if len(static.bm_morph):
        rates = leaf[jnp.asarray(static.bm_morph)]
        bones = jnp.asarray(static.bm_bone)
        morph_trans = morph_trans.at[bones].add(
            jnp.asarray(static.bm_trans) * rates[:, None])

        # rotations compose in morph order:
        # morph_rotation = morph_rotation ⊗ slerp(id, q, rate)
        rots = jnp.asarray(static.bm_rot)
        ident = m3.quat_identity(())

        def step(acc, inp):
            bone, q, rate = inp
            delta = m3.quat_slerp(ident, q, rate)
            delta = jnp.where(rate >= _EPS, delta, ident)
            cur = acc[bone]
            return acc.at[bone].set(m3.quat_mul(cur, delta)), None

        morph_rot, _ = jax.lax.scan(step, morph_rot, (bones, rots, rates))

    return vertex_offsets, morph_rot, morph_trans, leaf


def uv_morph_offsets(static: ModelStatic, leaf_rates: jnp.ndarray):
    """[N,2] UV offsets from MORPH_UV entries at the given leaf rates.

    Beyond-parity: the reference parses UV morphs and never applies them
    (poser_impl.inl:355-358). Gated by AppConfig.apply_extended_morphs."""
    n = len(static.positions)
    out = jnp.zeros((n, 2), jnp.float32)
    if len(static.um_morph) == 0 or static.n_morphs == 0:
        return out
    rates = leaf_rates[jnp.asarray(static.um_morph)]
    return out.at[jnp.asarray(static.um_vertex)].add(
        jnp.asarray(static.um_offset) * rates[:, None])


def ext_uv_morph_offsets(static: ModelStatic, leaf_rates: jnp.ndarray):
    """[N,E,4] offsets from MORPH_EXT_UV_1..4 entries at the given leaf
    rates (E = the model's declared extra-UV channel count).

    Beyond-parity D5 completion: the reference parses ext-UV morphs and
    never applies them (poser_impl.inl:355-358); the built-in shader here
    samples no extra-UV channel either, so these offsets feed
    Scene.morphed_extra_uvs for custom-effect consumers."""
    n = len(static.positions)
    e = static.extra_uvs.shape[1]
    out = jnp.zeros((n, max(e, 1), 4), jnp.float32)[:, :e]
    if len(static.xum_morph) == 0 or static.n_morphs == 0 or e == 0:
        return out
    rates = leaf_rates[jnp.asarray(static.xum_morph)]
    flat = (jnp.asarray(static.xum_vertex) * e
            + jnp.asarray(static.xum_channel))
    return out.reshape(n * e, 4).at[flat].add(
        jnp.asarray(static.xum_offset) * rates[:, None]).reshape(n, e, 4)


def material_morph_factors(static: ModelStatic, leaf_rates: jnp.ndarray):
    """-> (mul [P,3], add [P,3]) albedo modifiers from material morphs.

    PMX material-morph semantics per entry with weight w: multiply sets
    v *= lerp(1, payload, w), additive sets v += payload * w. The payload's
    diffuse RGB (floats 0:3) and texture tint RGB (floats 16:19) both scale
    the sampled albedo in this renderer's shading model, so their effects
    are combined here. Beyond-parity (the reference applies none of it)."""
    pn = len(static.part_base)
    mul = jnp.ones((pn, 3), jnp.float32)
    add = jnp.zeros((pn, 3), jnp.float32)
    if len(static.mm_morph) == 0 or static.n_morphs == 0:
        return mul, add
    w = leaf_rates[jnp.asarray(static.mm_morph)][:, None]      # [K,1]
    pay = jnp.asarray(static.mm_payload)
    diff = pay[:, 0:3]
    tint = pay[:, 16:19]
    parts = jnp.asarray(static.mm_part)
    is_mul = (jnp.asarray(static.mm_method) == 0)[:, None]
    # multiply entries compose multiplicatively per part; a scan keeps the
    # exact product in table order (entry counts are tiny)
    factor = jnp.where(is_mul, (1 + w * (diff - 1)) * (1 + w * (tint - 1)),
                       1.0)
    term = jnp.where(is_mul, 0.0, w * (diff + tint))

    def step(carry, inp):
        mul, add = carry
        p, f, t = inp
        return (mul.at[p].multiply(f), add.at[p].add(t)), None

    (mul, add), _ = jax.lax.scan(step, (mul, add), (parts, factor, term))
    return mul, add


# ---------------------------------------------------------------------------
# FK (UpdateBoneTransform, poser_impl.inl:142-166)
# ---------------------------------------------------------------------------

def _fk_bones(static: ModelStatic, pose: PoseArrays, idx, anim_rot, anim_trans,
              morph_rot, morph_trans, active=None) -> PoseArrays:
    """Batched FK update of the bones in `idx` (same-level: dependencies are
    already up to date in `pose`). `active` ([len(idx)] bool) gates writes
    per bone (used by grouped IK solves to freeze converged chains)."""
    idx = jnp.asarray(idx)
    parent = jnp.asarray(static.bone_parent)[idx]
    app = jnp.asarray(static.append_parent)[idx]
    app_ratio = jnp.asarray(static.append_ratio)[idx][:, None]
    app_rot_m = jnp.asarray(static.append_rotate)[idx][:, None]
    app_trn_m = jnp.asarray(static.append_translate)[idx][:, None]
    is_link = jnp.asarray(static.is_ik_link)[idx][:, None]
    offset = jnp.asarray(static.local_offset)[idx]

    total_rot = m3.quat_mul(morph_rot[idx], anim_rot[idx])
    total_trans = morph_trans[idx] + anim_trans[idx]

    app_safe = jnp.maximum(app, 0)
    ident = m3.quat_identity((idx.shape[0],))
    app_q = m3.quat_slerp(ident, pose.total_rot[app_safe],
                          app_ratio[:, 0])
    total_rot = jnp.where(app_rot_m & (app[:, None] >= 0),
                          m3.quat_mul(total_rot, app_q), total_rot)
    total_trans = total_trans + jnp.where(
        app_trn_m & (app[:, None] >= 0),
        app_ratio * pose.total_trans[app_safe], 0.0)

    pre_ik = jnp.where(is_link, total_rot, pose.pre_ik_rot[idx])
    total_rot = jnp.where(is_link, m3.quat_mul(pose.ik_rot[idx], total_rot),
                          total_rot)

    local = m3.affine(m3.quat_to_mat3(total_rot), total_trans + offset)
    parent_safe = jnp.maximum(parent, 0)
    pw = jnp.where((parent >= 0)[:, None, None], pose.world[parent_safe],
                   jnp.eye(4, dtype=jnp.float32))
    world = pw @ local

    if active is not None:
        a1 = active[:, None]
        world = jnp.where(active[:, None, None], world, pose.world[idx])
        total_rot = jnp.where(a1, total_rot, pose.total_rot[idx])
        total_trans = jnp.where(a1, total_trans, pose.total_trans[idx])
        pre_ik = jnp.where(a1, pre_ik, pose.pre_ik_rot[idx])

    return pose.replace(
        world=pose.world.at[idx].set(world),
        total_rot=pose.total_rot.at[idx].set(total_rot),
        total_trans=pose.total_trans.at[idx].set(total_trans),
        pre_ik_rot=pose.pre_ik_rot.at[idx].set(pre_ik),
    )


def _limit_euler(euler, emin, emax, mirror):
    """LimitEulerAngle (poser_impl.inl:178-193); `mirror` is the i<ikt flag."""
    def clamp_lo(e):
        tf = 2 * emin - e
        return jnp.where(e < emin, jnp.where((tf <= emax) & mirror, tf, emin), e)

    def clamp_hi(e):
        tf = 2 * emax - e
        return jnp.where(e > emax, jnp.where((tf >= emin) & mirror, tf, emax), e)

    return clamp_hi(clamp_lo(euler))


def _solve_ik_group(static: ModelStatic, pose: PoseArrays,
                    iks: list[IKProgram], anim_rot, anim_trans, morph_rot,
                    morph_trans) -> PoseArrays:
    """CCD IK (poser_impl.inl:168-310), batched over a group of independent
    same-shaped chains (model._group_iks) — e.g. both legs solve in one set of
    vector ops, halving the sequential iteration count. The link loop is
    statically unrolled; iterations run in a while_loop with per-chain freeze
    masks, exiting when every chain converges (the reference's early return).
    """
    g = len(iks)
    nl = len(iks[0].links)
    links = np.stack([ik.links for ik in iks])              # [G,L]
    link_parents = np.stack([ik.link_parents for ik in iks])
    targets = np.asarray([ik.target for ik in iks], np.int32)
    goal_bones = np.asarray([ik.bone for ik in iks], np.int32)
    loop = iks[0].loop
    ikt = loop // 2
    angle_limit = jnp.asarray([ik.angle_limit for ik in iks], jnp.float32)
    limits_min = jnp.asarray(np.stack([ik.limits_min for ik in iks]))  # [G,L,3]
    limits_max = jnp.asarray(np.stack([ik.limits_max for ik in iks]))
    fix_types = iks[0].fix_types      # same across group (signature)
    orders = iks[0].orders
    limited = iks[0].limited

    ident_g = jnp.broadcast_to(jnp.asarray([0, 0, 0, 1.0], jnp.float32),
                               (g * nl, 4))
    pose = pose.replace(
        ik_rot=pose.ik_rot.at[jnp.asarray(links.reshape(-1))].set(ident_g))
    ik_position = pose.world[jnp.asarray(goal_bones)][:, :3, 3]      # [G,3]
    for jj in range(nl - 1, -1, -1):
        pose = _fk_bones(static, pose, links[:, jj], anim_rot, anim_trans,
                         morph_rot, morph_trans)
    pose = _fk_bones(static, pose, targets, anim_rot, anim_trans,
                     morph_rot, morph_trans)
    target_pos = pose.world[jnp.asarray(targets)][:, :3, 3]          # [G,3]

    err = ik_position - target_pos
    done0 = jnp.sum(err * err, -1) < _EPS                            # [G]

    eye4 = jnp.eye(4, dtype=jnp.float32)

    def fk_targets(world, total_rot, ik_rot, active):
        tmp = pose.replace(world=world, total_rot=total_rot, ik_rot=ik_rot)
        tmp = _fk_bones(static, tmp, targets, anim_rot, anim_trans,
                        morph_rot, morph_trans, active=active)
        return tmp.world, tmp.total_rot

    def refresh_links(world, total_rot, ik_rot, k, active):
        """Chain refresh (poser_impl.inl:292-300), batched over chains."""
        bk = jnp.asarray(links[:, k])
        tr = m3.quat_mul(ik_rot[bk], pose.pre_ik_rot[bk])
        local = m3.affine(m3.quat_to_mat3(tr),
                          pose.total_trans[bk]
                          + jnp.asarray(static.local_offset)[bk])
        p = link_parents[:, k]
        pw = jnp.where((p >= 0)[:, None, None],
                       world[jnp.asarray(np.maximum(p, 0))], eye4)
        new_world = pw @ local
        world = world.at[bk].set(
            jnp.where(active[:, None, None], new_world, world[bk]))
        total_rot = total_rot.at[bk].set(
            jnp.where(active[:, None], tr, total_rot[bk]))
        return world, total_rot

    def iteration(carry):
        i, world, total_rot, ik_rot, target_pos, done = carry
        active = ~done                                              # [G]
        mirror = i < ikt
        pre_ik_rot = pose.pre_ik_rot

        for j in range(nl):
            if fix_types[j] == FIX_ALL:
                continue  # statically skipped (poser_impl.inl:215)
            b = jnp.asarray(links[:, j])
            link_pos = world[b][:, :3, 3]
            target_dir = link_pos - target_pos
            ik_dir = link_pos - ik_position
            target_dir = target_dir / jnp.maximum(
                jnp.linalg.norm(target_dir, axis=-1, keepdims=True), _EPS)
            ik_dir = ik_dir / jnp.maximum(
                jnp.linalg.norm(ik_dir, axis=-1, keepdims=True), _EPS)

            axis = jnp.cross(target_dir, ik_dir)
            axis = jnp.where(jnp.abs(axis) < _EPS, jnp.float32(_EPS), axis)

            p = link_parents[:, j]
            loc = jnp.where((p >= 0)[:, None, None],
                            world[jnp.asarray(np.maximum(p, 0))], eye4)

            if bool(limited[j]) and fix_types[j] != FIX_NONE:
                # axis pinned to the parent-local fixed axis while i < ikt
                ai = {FIX_X: 0, FIX_Y: 1, FIX_Z: 2}[int(fix_types[j])]
                sign = jnp.where(
                    jnp.sum(axis * loc[:, :3, ai], -1) >= 0, 1.0, -1.0)
                fixed_axis = jnp.zeros((g, 3), jnp.float32).at[:, ai].set(sign)
                free_axis = jnp.einsum("gji,gj->gi", loc[:, :3, :3], axis)
                free_axis = free_axis / jnp.maximum(
                    jnp.linalg.norm(free_axis, axis=-1, keepdims=True), _EPS)
                axis = jnp.where(mirror, fixed_axis, free_axis)
            else:
                axis = jnp.einsum("gji,gj->gi", loc[:, :3, :3], axis)
                axis = axis / jnp.maximum(
                    jnp.linalg.norm(axis, axis=-1, keepdims=True), _EPS)

            cosang = jnp.clip(jnp.sum(target_dir * ik_dir, -1), -1.0, 1.0)
            angle = jnp.minimum(jnp.arccos(cosang), angle_limit * (j + 1))
            q = m3.axis_angle_to_quat(axis, angle)
            new_ik = m3.quat_mul(q, ik_rot[b])

            if bool(limited[j]):
                local_rotation = m3.quat_mul(new_ik, pre_ik_rot[b])
                order = orders[j]
                euler = m3.quat_to_euler(local_rotation, order)
                euler = _limit_euler(euler, limits_min[:, j], limits_max[:, j],
                                     mirror)
                local_rotation = m3.euler_to_quat(euler, order)
                new_ik = m3.quat_mul(local_rotation,
                                     m3.quat_conj(pre_ik_rot[b]))
            ik_rot = ik_rot.at[b].set(
                jnp.where(active[:, None], new_ik, ik_rot[b]))

            # refresh chain worlds from this link down to links[0]
            for k in range(j, -1, -1):
                world, total_rot = refresh_links(world, total_rot, ik_rot, k,
                                                 active)
            world, total_rot = fk_targets(world, total_rot, ik_rot, active)
            tp = world[jnp.asarray(targets)][:, :3, 3]
            target_pos = jnp.where(active[:, None], tp, target_pos)

        err = ik_position - target_pos
        done = done | (jnp.sum(err * err, -1) < _EPS)
        return i + 1, world, total_rot, ik_rot, target_pos, done

    # early exit when every chain converges, matching the reference's
    # mid-loop return (poser_impl.inl:305-308)
    def cond(carry):
        i, *_, done = carry
        return (i < loop) & jnp.any(~done)

    _, world, total_rot, ik_rot, target_pos, _ = jax.lax.while_loop(
        cond, iteration,
        (jnp.int32(0), pose.world, pose.total_rot, pose.ik_rot, target_pos,
         done0))
    return pose.replace(world=world, total_rot=total_rot, ik_rot=ik_rot)


def _run_segments(static: ModelStatic, pose: PoseArrays, segments,
                  anim_rot, anim_trans, morph_rot, morph_trans) -> PoseArrays:
    for seg in segments:
        if seg.kind == "fk":
            for level in seg.levels:
                pose = _fk_bones(static, pose, level, anim_rot, anim_trans,
                                 morph_rot, morph_trans)
        else:
            goal_bones = np.asarray([ik.bone for ik in seg.iks], np.int32)
            pose = _fk_bones(static, pose, goal_bones, anim_rot, anim_trans,
                             morph_rot, morph_trans)
            pose = _solve_ik_group(static, pose, seg.iks, anim_rot,
                                   anim_trans, morph_rot, morph_trans)
    return pose


def _update_skin(static: ModelStatic, pose: PoseArrays, bones) -> PoseArrays:
    """skinning = world @ T(-rest) (UpdateBoneSkinningMatrix, only for the
    listed bones — physics-written matrices of other bones must survive)."""
    if len(bones) == 0:
        return pose
    idx = jnp.asarray(bones)
    w = pose.world[idx]
    rest = jnp.asarray(static.bone_rest)[idx]
    trans = w[:, :3, 3] - jnp.einsum("bij,bj->bi", w[:, :3, :3], rest)
    skin = w.at[:, :3, 3].set(trans)
    return pose.replace(skin=pose.skin.at[idx].set(skin))


def _segment_bones(segments) -> list[int]:
    out = []
    for seg in segments:
        if seg.kind == "fk":
            for level in seg.levels:
                out.extend(int(b) for b in level)
        else:
            out.extend(ik.bone for ik in seg.iks)
    return out


def pre_physics_posing(static: ModelStatic, anim_rot, anim_trans,
                       morph_rates) -> PoseArrays:
    """PrePhysicsPosing (poser_impl.inl:362-389): clear, morphs, FK+IK over
    pre-physics bones, skinning matrices for those bones."""
    pose = init_pose(static)
    vertex_offsets, morph_rot, morph_trans, leaf = apply_morphs(static,
                                                                morph_rates)
    pose = pose.replace(vertex_offsets=vertex_offsets, leaf_rates=leaf)
    pose = _run_segments(static, pose, static.pre_segments,
                         anim_rot, anim_trans, morph_rot, morph_trans)
    pre_bones = _segment_bones(static.pre_segments)
    return _update_skin(static, pose, pre_bones)


def post_physics_posing(static: ModelStatic, pose: PoseArrays, anim_rot,
                        anim_trans, morph_rates) -> PoseArrays:
    """PostPhysicsPosing (poser_impl.inl:391-394)."""
    if static.n_morphs:
        _, morph_rot, morph_trans, _ = apply_morphs(static, morph_rates)
    else:
        morph_rot = m3.quat_identity((static.n_bones,))
        morph_trans = jnp.zeros((static.n_bones, 3), jnp.float32)
    pose = _run_segments(static, pose, static.post_segments,
                         anim_rot, anim_trans, morph_rot, morph_trans)
    post_bones = _segment_bones(static.post_segments)
    return _update_skin(static, pose, post_bones)


# ---------------------------------------------------------------------------
# Deform (poser_impl.inl:396-461): uniform 4-wide linear blend skinning
# ---------------------------------------------------------------------------

def deform(static: ModelStatic, pose: PoseArrays, use_matmul=None,
           sdef=False):
    """-> (positions [N,3], normals [N,3]) in MMD units.

    BDEF1/BDEF2/BDEF4 and the reference's SDEF->BDEF2 matrix-lerp fallback all
    reduce to M = sum_k w_k * skin[b_k] on 4-wide normalized tables. When the
    dense weight matrix exists, the blend runs as a bone-palette matmul
    (ops/skinning.py); otherwise (or on request) a 4-wide gather.

    sdef=True enables TRUE spherical SDEF for the vertices that kept
    SDEF through Model::Normalize — the path the reference has only as
    commented-out code (poser_impl.inl:438-458; it ships the BDEF2
    matrix-lerp fallback at :417-425, which sdef=False matches)."""
    if use_matmul is None:
        use_matmul = static.skin_weight_dense is not None
    if use_matmul and static.skin_weight_dense is not None:
        from ..ops.skinning import skin_matmul
        out_pos, out_nrm = skin_matmul(static.skin_weight_dense, pose.skin,
                                       jnp.asarray(static.positions),
                                       pose.vertex_offsets,
                                       jnp.asarray(static.normals))
    else:
        bones = jnp.asarray(static.skin_bones)      # [N,4]
        weights = jnp.asarray(static.skin_weights)  # [N,4]
        mats = pose.skin[bones]                     # [N,4,4,4]
        blend = jnp.einsum("nk,nkij->nij", weights, mats)
        p = jnp.asarray(static.positions) + pose.vertex_offsets
        out_pos = (jnp.einsum("nij,nj->ni", blend[:, :3, :3], p)
                   + blend[:, :3, 3])
        out_nrm = jnp.einsum("nij,nj->ni", blend[:, :3, :3],
                             jnp.asarray(static.normals))
    if sdef:
        out_pos, out_nrm = _sdef_overwrite(static, pose, out_pos, out_nrm)
    return out_pos, out_nrm


def _sdef_overwrite(static: ModelStatic, pose: PoseArrays, out_pos, out_nrm):
    """Spherical SDEF for the (host-static) SDEF vertex subset.

    Rotation is the slerp of the two bone rotations; translation anchors
    through the center point C with the R0/R1 correction, so the skin bulges
    around the joint instead of collapsing like linear matrix-lerp:

        rw  = w0*R0 + w1*R1
        cr0 = (C + (C + R0 - rw)) / 2,  cr1 = (C + (C + R1 - rw)) / 2
        p'  = slerp(q0, q1, w1) * (p - C) + w0*(M0 @ cr0) + w1*(M1 @ cr1)

    (the standard MMD SDEF formulation, e.g. saba's implementation)."""
    from ..formats import pmx as P
    idx_np = np.nonzero(np.asarray(static.skin_type) == P.SDEF)[0]
    if len(idx_np) == 0:
        return out_pos, out_nrm
    idx = jnp.asarray(idx_np)
    b0 = jnp.asarray(static.skin_bones[idx_np, 0])
    b1 = jnp.asarray(static.skin_bones[idx_np, 1])
    w0 = jnp.asarray(static.skin_weights[idx_np, 0])[:, None]
    w1 = 1.0 - w0
    m0 = pose.skin[b0]
    m1 = pose.skin[b1]
    q0 = m3.mat3_to_quat(m0[:, :3, :3])
    q1 = m3.mat3_to_quat(m1[:, :3, :3])
    qb = m3.quat_slerp(q0, q1, w1[:, 0])

    c = jnp.asarray(static.sdef_c[idx_np])
    r0 = jnp.asarray(static.sdef_r0[idx_np])
    r1 = jnp.asarray(static.sdef_r1[idx_np])
    rw = r0 * w0 + r1 * w1
    cr0 = c + (r0 - rw) * 0.5
    cr1 = c + (r1 - rw) * 0.5

    def apply(m, v):
        return jnp.einsum("nij,nj->ni", m[:, :3, :3], v) + m[:, :3, 3]

    p = (jnp.asarray(static.positions)[idx] + pose.vertex_offsets[idx])
    pos = m3.quat_rotate(qb, p - c) + w0 * apply(m0, cr0) + w1 * apply(m1, cr1)
    nrm = m3.quat_rotate(qb, jnp.asarray(static.normals)[idx])
    return out_pos.at[idx].set(pos), out_nrm.at[idx].set(nrm)
