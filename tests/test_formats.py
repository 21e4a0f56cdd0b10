import numpy as np
import pytest

from simple_mmd_renderer.formats import pmx as P
from simple_mmd_renderer.formats import vmd as V
from simple_mmd_renderer.formats.writers import write_pmx, write_vmd

from fixtures import two_bone_arm, ik_leg


@pytest.mark.parametrize("utf8", [True, False])
def test_pmx_roundtrip_vertices_and_names(utf8):
    m = two_bone_arm()
    data = write_pmx(m, utf8=utf8)
    out = P.parse_pmx(data)
    assert out.name == "arm"
    assert out.bones[0].name == "センター"
    np.testing.assert_array_equal(out.positions, m.positions)
    np.testing.assert_array_equal(out.triangles, m.triangles)
    np.testing.assert_array_equal(out.skin_type, m.skin_type)
    np.testing.assert_array_equal(out.skin_bones, m.skin_bones)
    # BDEF2/SDEF second weight is derived as 1-w at parse
    np.testing.assert_allclose(out.skin_weights[1], [0.25, 0.75, 0, 0], atol=1e-6)
    np.testing.assert_allclose(out.skin_weights[3], [0.5, 0.5, 0, 0], atol=1e-6)
    np.testing.assert_array_equal(out.sdef_c[3], [1, 0, 0])
    assert out.textures == ["tex/body.png"]
    assert out.materials[0].n_triangles == 2
    assert out.materials[0].base_shift == 0
    assert out.materials[0].texture == 0


def test_pmx_roundtrip_morphs():
    m = two_bone_arm()
    out = P.parse_pmx(write_pmx(m))
    assert [mo.type for mo in out.morphs] == [P.MORPH_VERTEX, P.MORPH_BONE, P.MORPH_GROUP]
    np.testing.assert_allclose(out.morphs[0].vertex_offsets, [[0, 0.5, 0]])
    np.testing.assert_allclose(out.morphs[1].bone_rotations,
                               [[0, 0, 0.3826834, 0.9238795]], atol=1e-6)
    np.testing.assert_allclose(out.morphs[2].group_rates, [0.5])


def test_pmx_roundtrip_ik():
    m = ik_leg()
    out = P.parse_pmx(write_pmx(m))
    ik = out.bones[4]
    assert ik.has(P.BONE_HAS_IK)
    assert ik.ik_target == 3
    assert ik.ik_loop == 40
    assert ik.ik_angle == pytest.approx(2.0)
    assert [l.bone for l in ik.ik_links] == [2, 1]
    assert ik.ik_links[0].has_limit and not ik.ik_links[1].has_limit
    np.testing.assert_allclose(ik.ik_links[0].lo, [-np.pi, 0, 0], atol=1e-6)


def test_pmx_rigid_bodies_and_constraints():
    m = two_bone_arm()
    m.rigid_bodies = [
        P.RigidBody("体", "body", 0, 0, 0xFFFF, P.SHAPE_CAPSULE,
                    np.array([0.5, 1.0, 0], np.float32),
                    np.array([0, 1, 0], np.float32),
                    np.array([0, 0, 0.1], np.float32),
                    1.0, 0.5, 0.5, 0.0, 0.5, P.RIGID_KINEMATIC),
        P.RigidBody("髪", "hair", 1, 1, 0xFFFE, P.SHAPE_SPHERE,
                    np.array([0.3, 0, 0], np.float32),
                    np.array([1, 0, 0], np.float32),
                    np.zeros(3, np.float32),
                    0.1, 0.9, 0.9, 0.0, 0.3, P.RIGID_PHYSICS),
    ]
    m.constraints = [
        P.Constraint("j", "j", 0, 1, np.array([0.5, 0.5, 0], np.float32),
                     np.zeros(3, np.float32),
                     np.zeros(3, np.float32), np.zeros(3, np.float32),
                     np.array([-0.1, -0.1, -0.1], np.float32),
                     np.array([0.1, 0.1, 0.1], np.float32),
                     np.zeros(3, np.float32), np.array([10, 10, 10], np.float32)),
    ]
    out = P.parse_pmx(write_pmx(m))
    assert len(out.rigid_bodies) == 2
    rb = out.rigid_bodies[1]
    assert rb.bone == 1 and rb.shape == P.SHAPE_SPHERE and rb.type == P.RIGID_PHYSICS
    assert rb.mask == 0xFFFE
    np.testing.assert_allclose(rb.dimensions, [0.3, 0, 0])
    c = out.constraints[0]
    assert (c.body_a, c.body_b) == (0, 1)
    np.testing.assert_allclose(c.rot_hi, [0.1, 0.1, 0.1], atol=1e-6)
    np.testing.assert_allclose(c.spring_rotate, [10, 10, 10])


def test_vmd_roundtrip():
    interp_ease = np.array([[20, 20, 107, 107],   # x: linear (c0x==c0y, c1x==c1y)
                            [5, 80, 30, 120],     # y: strong ease
                            [20, 20, 107, 107],
                            [64, 0, 64, 127]], np.int8)
    data = write_vmd(
        "テスト",
        bone_keys=[
            ("センター", 0, np.zeros(3), np.array([0, 0, 0, 1.0]), interp_ease),
            ("センター", 30, np.array([0, 1, 0.0]),
             np.array([0, 0.7071068, 0, 0.7071068]), interp_ease),
            ("腕", 10, np.array([1, 0, 0.0]), np.array([0, 0, 0, 1.0]), interp_ease),
        ],
        morph_keys=[("にっこり", 0, 0.0), ("にっこり", 20, 1.0)],
        camera_keys=[{"frame": 0, "position": (0, 10, -20), "fov": 30.0}],
    )
    mo = V.parse_vmd(data)
    assert mo.name == "テスト"
    assert set(mo.bone_tracks) == {"センター", "腕"}
    t = mo.bone_tracks["センター"]
    np.testing.assert_array_equal(t.frames, [0, 30])
    np.testing.assert_allclose(t.translations[1], [0, 1, 0])
    np.testing.assert_allclose(t.rotations[1], [0, 0.7071068, 0, 0.7071068])
    # channel y (index 1) control points
    np.testing.assert_allclose(t.c0[0, 1], [5 / 127, 80 / 127], atol=1e-6)
    np.testing.assert_allclose(t.c1[0, 1], [30 / 127, 120 / 127], atol=1e-6)
    mt = mo.morph_tracks["にっこり"]
    np.testing.assert_array_equal(mt.frames, [0, 20])
    np.testing.assert_allclose(mt.weights, [0.0, 1.0])
    assert mo.camera is not None
    np.testing.assert_allclose(mo.camera.positions[0], [0, 10, -20])
    assert mo.length == 30


def test_native_loader_matches_python():
    import simple_mmd_renderer.native as N
    from fixtures import two_bone_arm
    if N.get_lib() is None:
        import pytest
        pytest.skip("native toolchain unavailable")
    m = two_bone_arm()
    data = write_pmx(m)
    a = P.parse_pmx(data)
    lib, tried = N._lib, N._tried
    N._lib, N._tried = None, True       # force python fallback
    try:
        b = P.parse_pmx(data)
    finally:
        N._lib, N._tried = lib, tried
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.skin_bones, b.skin_bones)
    np.testing.assert_array_equal(a.skin_weights, b.skin_weights)
    np.testing.assert_array_equal(a.skin_type, b.skin_type)
    np.testing.assert_array_equal(a.sdef_c, b.sdef_c)


def test_vmd_light_track_roundtrip_and_sampling():
    """VMD light section (after camera): parse + device-side linear lerp.
    The reference declares LightMotionReader but never implements it
    (light_motion_reader.inl:14-16) — this is the beyond-parity path."""
    data = write_vmd(
        "light",
        bone_keys=[("センター", 0, np.zeros(3), np.array([0, 0, 0, 1.0]),
                    np.array([[20, 20, 107, 107]] * 4, np.int8))],
        camera_keys=[{"frame": 0, "position": (0, 10, -20), "fov": 30.0}],
        light_keys=[
            {"frame": 0, "color": (1.0, 1.0, 1.0), "direction": (0, -1, 0)},
            {"frame": 20, "color": (1.0, 0.0, 0.0), "direction": (1, -1, 0)},
        ],
    )
    mo = V.parse_vmd(data)
    assert mo.light is not None
    np.testing.assert_array_equal(mo.light.frames, [0, 20])
    np.testing.assert_allclose(mo.light.colors[1], [1, 0, 0])

    from simple_mmd_renderer.render.camera_anim import (bind_light,
                                                            sample_light)
    la = bind_light(mo.light)
    # midpoint lerps color; direction renormalizes
    s = sample_light(la, 10.0)
    np.testing.assert_allclose(np.asarray(s["color"]), [1.0, 0.5, 0.5],
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(s["direction"])),
                               1.0, atol=1e-6)
    # clamps outside the key range
    np.testing.assert_allclose(np.asarray(sample_light(la, -5.0)["color"]),
                               [1, 1, 1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(sample_light(la, 99.0)["color"]),
                               [1, 0, 0], atol=1e-6)
    # light section is optional: older writers stop at camera
    mo2 = V.parse_vmd(write_vmd("nolight", bone_keys=[
        ("b", 0, np.zeros(3), np.array([0, 0, 0, 1.0]),
         np.array([[20, 20, 107, 107]] * 4, np.int8))]))
    assert mo2.light is None
