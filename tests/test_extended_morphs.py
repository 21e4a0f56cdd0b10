"""UV-morph and material-morph application (beyond-parity: the reference
parses both and applies neither — poser_impl.inl:355-358)."""

import numpy as np
import jax.numpy as jnp

from simple_mmd_renderer.formats import pmx as P
from simple_mmd_renderer.core import model as M
from simple_mmd_renderer.core import pose as PO
from simple_mmd_renderer.render.pipeline import render_frame
from simple_mmd_renderer.config import RenderConfig

from fixtures import two_bone_arm


def _model_with_extended_morphs():
    pm = two_bone_arm()
    pm.morphs.append(P.Morph("UV", "uv", 4, P.MORPH_UV,
                             uv_vertex_indices=np.array([1, 3], np.int32),
                             uv_offsets=np.array([[0.25, 0.0, 0, 0],
                                                  [0.0, -0.5, 0, 0]],
                                                 np.float32)))
    payload_mul = np.ones(28, np.float32)
    payload_mul[0:3] = [0.5, 1.0, 1.0]       # diffuse RGB
    payload_add = np.zeros(28, np.float32)
    payload_add[0:3] = [0.0, 0.25, 0.0]
    pm.morphs.append(P.Morph("暗く", "darken", 4, P.MORPH_MATERIAL,
                             material_indices=np.array([0], np.int32),
                             material_methods=np.array([0], np.uint8),
                             material_payload=payload_mul[None]))
    pm.morphs.append(P.Morph("緑", "greener", 4, P.MORPH_MATERIAL,
                             material_indices=np.array([-1], np.int32),
                             material_methods=np.array([1], np.uint8),
                             material_payload=payload_add[None]))
    return pm, M.build_model(pm)


def test_uv_morph_offsets_scale_with_rate():
    pm, static = _model_with_extended_morphs()
    uv_idx = 3  # after the fixture's 3 morphs
    rates = np.zeros(static.n_morphs, np.float32)
    rates[uv_idx] = 0.5
    off = np.asarray(PO.uv_morph_offsets(static, jnp.asarray(rates)))
    np.testing.assert_allclose(off[1], [0.125, 0.0], atol=1e-6)
    np.testing.assert_allclose(off[3], [0.0, -0.25], atol=1e-6)
    assert (off[[0, 2]] == 0).all()


def test_material_morph_mul_and_add():
    pm, static = _model_with_extended_morphs()
    rates = np.zeros(static.n_morphs, np.float32)
    rates[4] = 0.5   # darken (mul)
    rates[5] = 1.0   # greener (add, all-materials form)
    mul, add = PO.material_morph_factors(static, jnp.asarray(rates))
    # mul: lerp(1, 0.5, 0.5) = 0.75 on red
    np.testing.assert_allclose(np.asarray(mul)[0], [0.75, 1.0, 1.0],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(add)[0], [0.0, 0.25, 0.0],
                               atol=1e-6)


def test_material_morph_zero_rates_identity():
    pm, static = _model_with_extended_morphs()
    rates = np.zeros(static.n_morphs, np.float32)
    mul, add = PO.material_morph_factors(static, jnp.asarray(rates))
    np.testing.assert_allclose(np.asarray(mul), 1.0, atol=0)
    np.testing.assert_allclose(np.asarray(add), 0.0, atol=0)
    off = np.asarray(PO.uv_morph_offsets(static, jnp.asarray(rates)))
    np.testing.assert_allclose(off, 0.0, atol=0)


def test_render_frame_part_color_modulates_character():
    pm, static = _model_with_extended_morphs()
    cfg = RenderConfig(width=96, height=64, shadow_map_size=64,
                       show_skybox=False, show_ground=False,
                       camera_pos=np.array([0.1, 0.05, -0.5], np.float32),
                       camera_target=np.array([0.1, 0.05, 0.0], np.float32))
    args = (static, jnp.asarray(static.positions),
            jnp.asarray(static.normals), cfg)
    base = np.asarray(render_frame(*args))
    pn = len(static.part_base)
    mul = jnp.full((pn, 3), 0.3)
    add = jnp.zeros((pn, 3))
    dark = np.asarray(render_frame(*args, part_color=(mul, add)))
    clear = np.asarray(cfg.clear_color)
    char = np.abs(base - clear).sum(-1) > 0.05
    assert char.any(), "character must be visible in the test framing"
    assert (dark[char].mean() < base[char].mean() - 0.05)
    # background unchanged
    np.testing.assert_allclose(dark[~char], base[~char], atol=1e-6)


def test_ext_uv_morph_offsets_per_channel():
    """Ext-UV morphs (channels 1-4) apply per declared channel, scaled by
    the leaf rate (D5 completion; the reference parses them and never
    applies — poser_impl.inl:355-358)."""
    pm = two_bone_arm()
    n = len(pm.positions)
    pm.extra_uvs = np.tile(np.asarray([[0.1, 0.2, 0.3, 0.4],
                                       [0.5, 0.6, 0.7, 0.8]], np.float32),
                           (n, 1, 1))                       # E = 2
    pm.morphs.append(P.Morph("X1", "x1", 4, P.MORPH_EXT_UV_1,
                             uv_vertex_indices=np.array([1, 2], np.int32),
                             uv_offsets=np.array([[1, 2, 3, 4],
                                                  [4, 3, 2, 1]],
                                                 np.float32)))
    pm.morphs.append(P.Morph("X2", "x2", 4, P.MORPH_EXT_UV_2,
                             uv_vertex_indices=np.array([2], np.int32),
                             uv_offsets=np.array([[8, 8, 8, 8]],
                                                 np.float32)))
    # channel 3 not declared by the model (E=2): dropped at build
    pm.morphs.append(P.Morph("X3", "x3", 4, P.MORPH_EXT_UV_3,
                             uv_vertex_indices=np.array([0], np.int32),
                             uv_offsets=np.array([[9, 9, 9, 9]],
                                                 np.float32)))
    static = M.build_model(pm)
    assert static.extra_uvs.shape == (n, 2, 4)
    rates = np.zeros(static.n_morphs, np.float32)
    rates[3] = 0.5   # X1 (after the fixture's 3 morphs)
    rates[4] = 1.0   # X2
    rates[5] = 1.0   # X3 (dropped: channel >= E)
    off = np.asarray(PO.ext_uv_morph_offsets(static, jnp.asarray(rates)))
    np.testing.assert_allclose(off[1, 0], [0.5, 1.0, 1.5, 2.0], atol=1e-6)
    np.testing.assert_allclose(off[2, 0], [2.0, 1.5, 1.0, 0.5], atol=1e-6)
    np.testing.assert_allclose(off[2, 1], [8, 8, 8, 8], atol=1e-6)
    assert (off[0] == 0).all() and (off[1, 1] == 0).all()

    # the Scene query surface: rest values + offsets
    from simple_mmd_renderer.config import AppConfig
    from simple_mmd_renderer.core.scene import Scene
    from simple_mmd_renderer.core import physics as PH

    class _Pose:
        leaf_rates = jnp.asarray(rates)

    cfg = AppConfig()
    scene = Scene(static, PH.build_physics(static), None, cfg)
    out = np.asarray(scene.morphed_extra_uvs(_Pose()))
    np.testing.assert_allclose(out[2, 1], [8.5, 8.6, 8.7, 8.8], atol=1e-6)
    np.testing.assert_allclose(out[0, 0], [0.1, 0.2, 0.3, 0.4], atol=1e-6)


def test_ext_uv_tables_from_parsed_bytes():
    """The golden-bytes PMX (extra_uv_count=1, one MORPH_EXT_UV_1 morph)
    populates the xum tables through the real reader."""
    import sys
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_golden_bytes import build_pmx, Enc
    data = build_pmx(Enc(utf8=True, vert=1, tex=1, mat=1, bone=1, morph=1,
                         rigid=1))
    m = P.parse_pmx(data)
    static = M.build_model(m)
    assert static.extra_uvs.shape[1] == 1
    assert len(static.xum_morph) > 0
    assert (np.asarray(static.xum_channel) == 0).all()


def test_group_morph_drives_extended_leaves():
    """A group morph pointing at a material morph must drive it through the
    leaf-rate expansion."""
    pm, static = _model_with_extended_morphs()
    pm.morphs.append(P.Morph("G", "g", 0, P.MORPH_GROUP,
                             group_indices=np.array([4], np.int32),
                             group_rates=np.array([0.5], np.float32)))
    static = M.build_model(pm)
    rates = np.zeros(static.n_morphs, np.float32)
    rates[6] = 1.0   # the group morph
    leaf = rates @ static.morph_expand
    mul, _ = PO.material_morph_factors(static, jnp.asarray(leaf))
    np.testing.assert_allclose(np.asarray(mul)[0], [0.75, 1.0, 1.0],
                               atol=1e-6)
