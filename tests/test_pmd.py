import struct

import numpy as np

from simple_mmd_renderer.formats import pmd as PMD
from simple_mmd_renderer.formats import pmx as P
from simple_mmd_renderer.core import model as M
from simple_mmd_renderer.utils.io import encode_shift_jis


def _build_pmd_bytes():
    out = bytearray()
    w = out.extend
    w(b"Pmd")
    w(struct.pack("<f", 1.0))
    w(encode_shift_jis("テストモデル", 20))
    w(encode_shift_jis("説明", 256))

    # 3 vertices
    verts = [
        ((0, 0, 0), (0, 0, -1), (0, 0), (0, 1), 100, 0),
        ((1, 0, 0), (0, 0, -1), (0.5, 0), (0, 1), 60, 0),
        ((2, 0, 0), (0, 0, -1), (1, 0), (1, 0), 50, 1),
    ]
    w(struct.pack("<I", len(verts)))
    for pos, nrm, uv, bones, weight, non_edge in verts:
        w(struct.pack("<8f", *pos, *nrm, *uv))
        w(struct.pack("<hhBB", bones[0], bones[1], weight, non_edge))

    w(struct.pack("<I", 3))          # one triangle
    w(struct.pack("<3H", 0, 1, 2))

    # one material: diffuse w/ alpha 1, tex*sph pair
    w(struct.pack("<I", 1))
    w(struct.pack("<4f", 1, 1, 1, 1))
    w(struct.pack("<f", 20.0))
    w(struct.pack("<3f", 0.3, 0.3, 0.3))
    w(struct.pack("<3f", 0.5, 0.5, 0.5))
    w(struct.pack("<bB", 2, 1))      # toon 2, edge on
    w(struct.pack("<I", 3))          # 3 vertex indices
    w(encode_shift_jis("body.bmp*metal.sph", 20))

    # 5 bones: root(rot/trans), hip, knee(左ひざ), ankle, ik bone(type 2)
    bones = [
        ("センター", -1, 1, 1, 0, (0, 5, 0)),
        ("足", 0, 2, 0, 0, (0, 4, 0)),
        ("左ひざ", 1, 3, 0, 0, (0, 2, 0)),
        ("足首", 2, -1, 0, 0, (0, 0, 0)),
        ("足ＩＫ", -1, -1, 2, 0, (0, 0, 0)),
    ]
    w(struct.pack("<H", len(bones)))
    for name, parent, child, btype, ikn, pos in bones:
        w(encode_shift_jis(name, 20))
        w(struct.pack("<hhBh3f", parent, child, btype, ikn, *pos))

    # one IK block: bone 4 targets ankle(3), chain [knee(2), hip(1)]
    w(struct.pack("<H", 1))
    w(struct.pack("<hhBHf", 4, 3, 2, 30, 0.5))
    w(struct.pack("<2H", 2, 1))

    # faces: base + smile (indices into base)
    w(struct.pack("<H", 2))
    w(encode_shift_jis("base", 20))
    w(struct.pack("<IB", 2, 0))
    w(struct.pack("<I3f", 1, 0, 0, 0))   # base entry 0 -> vertex 1
    w(struct.pack("<I3f", 2, 0, 0, 0))   # base entry 1 -> vertex 2
    w(encode_shift_jis("笑い", 20))
    w(struct.pack("<IB", 1, 3))
    w(struct.pack("<I3f", 1, 0.0, 0.5, 0.0))  # base entry 1 => vertex 2

    # display lists
    w(struct.pack("<B", 0))
    w(struct.pack("<B", 0))
    w(struct.pack("<I", 0))

    # english block
    w(struct.pack("<B", 1))
    w(encode_shift_jis("TestModel", 20))
    w(encode_shift_jis("desc", 256))
    for name, *_ in bones:
        w(encode_shift_jis("bone_en", 20))
    w(encode_shift_jis("smile", 20))  # morphs minus base

    # toon table
    for i in range(10):
        w(encode_shift_jis(f"toon{i:02d}.bmp", 100))

    # rigid bodies: one on the knee (relative position), one unbound -> ghost
    w(struct.pack("<I", 2))
    w(encode_shift_jis("体", 20))
    w(struct.pack("<HBHB", 2, 0, 0xFFFF, 0))
    w(struct.pack("<14f", 0.5, 0, 0, 1.0, 2.0, 3.0, 0, 0, 0, 1.0, 0.5, 0.5,
                  0.0, 0.4))
    w(struct.pack("<B", 1))
    w(encode_shift_jis("浮遊", 20))
    w(struct.pack("<HBHB", 0xFFFF, 1, 0xFFFE, 0))
    w(struct.pack("<14f", 0.3, 0, 0, 0, 1, 0, 0, 0, 0, 0.1, 0.9, 0.9, 0, 0.2))
    w(struct.pack("<B", 1))

    # one constraint
    w(struct.pack("<I", 1))
    w(encode_shift_jis("joint", 20))
    w(struct.pack("<II", 0, 1))
    w(struct.pack("<24f", *([0.0] * 24)))
    return bytes(out)


def test_pmd_parses_to_model():
    m = PMD.parse_pmd(_build_pmd_bytes())
    assert m.name == "テストモデル"
    assert m.name_en == "TestModel"
    assert len(m.positions) == 3
    # BDEF2 weights from the byte / 100
    np.testing.assert_allclose(m.skin_weights[1, :2], [0.6, 0.4], atol=1e-6)
    np.testing.assert_array_equal(m.skin_bones[0, :2], [0, 1])
    # non_edge flag -> edge scale 0
    np.testing.assert_allclose(m.edge_scale, [1, 1, 0])
    # texture split on '*'
    assert m.textures == ["body.bmp", "metal.sph"]
    mat = m.materials[0]
    assert mat.texture == 0 and mat.sub_texture == 1
    assert mat.sub_texture_type == 1  # SPH
    assert mat.draw_flags & P.MAT_DRAW_EDGE
    assert mat.draw_flags & P.MAT_CAST_SELF_SHADOW
    assert not (mat.draw_flags & P.MAT_DOUBLE_FACE)


def test_pmd_bones_and_ik():
    m = PMD.parse_pmd(_build_pmd_bytes())
    assert [b.name for b in m.bones] == ["センター", "足", "左ひざ", "足首",
                                         "足ＩＫ"]
    root, hip, knee, ankle, ik = m.bones
    assert root.has(P.BONE_MOVABLE)            # type 1
    assert ik.has(P.BONE_HAS_IK) and ik.has(P.BONE_MOVABLE)
    assert ik.transform_level == 1
    assert ik.ik_target == 3
    assert ik.ik_loop == 30
    assert ik.ik_angle == np.float32(0.5 * 4.0)  # x4 (reader:310)
    assert [l.bone for l in ik.ik_links] == [2, 1]
    # knee limit is auto-applied by name
    assert ik.ik_links[0].has_limit
    np.testing.assert_allclose(ik.ik_links[0].lo, [-np.pi, 0, 0], atol=1e-6)
    assert not ik.ik_links[1].has_limit


def test_pmd_morph_base_remap():
    m = PMD.parse_pmd(_build_pmd_bytes())
    assert [mo.name for mo in m.morphs] == ["base", "笑い"]
    smile = m.morphs[1]
    # entry "1" indexes the base morph -> real vertex 2
    np.testing.assert_array_equal(smile.vertex_indices, [2])
    np.testing.assert_allclose(smile.vertex_offsets, [[0, 0.5, 0]])
    assert smile.name_en == "smile"


def test_pmd_rigid_bodies():
    m = PMD.parse_pmd(_build_pmd_bytes())
    assert len(m.rigid_bodies) == 2
    body = m.rigid_bodies[0]
    # bone-relative position -> absolute (knee at (0,2,0) + (1,2,3))
    np.testing.assert_allclose(body.position, [1, 4, 3], atol=1e-6)
    assert body.bone == 2 and body.type == P.RIGID_PHYSICS
    ghost = m.rigid_bodies[1]
    assert ghost.type == P.RIGID_PHYSICS_GHOST    # unbound -> ghost
    assert ghost.bone == 0                        # attached to センター
    assert len(m.constraints) == 1


def test_pmd_end_to_end_pose():
    import jax.numpy as jnp
    from simple_mmd_renderer.core import pose as PO
    m = PMD.parse_pmd(_build_pmd_bytes())
    static = M.build_model(m)
    b = static.n_bones
    rot = jnp.broadcast_to(jnp.asarray([0, 0, 0, 1.0], jnp.float32), (b, 4))
    trans = jnp.zeros((b, 3), jnp.float32).at[4].set(
        jnp.asarray([0.0, 1.0, 0.5]))
    rates = jnp.zeros((static.n_morphs,), jnp.float32)
    pose = PO.pre_physics_posing(static, rot, trans, rates)
    ankle = np.asarray(pose.world[3][:3, 3])
    assert np.linalg.norm(ankle - np.array([0, 1, 0.5])) < 0.2
