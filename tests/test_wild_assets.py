"""Realistic-scale "wild asset" validation (r2 VERDICT missing #1).

No redistributable real PMX/VMD exists in this offline environment, so
wild_assets.py synthesizes files carrying the hazards real assets stress:
ShiftJIS edge cases, 120-part material tables, deep/duplicated IK chains,
degenerate weights, global toon references, unsorted VMD keys with junk
after the name NUL. These tests parse them through both vertex parsers,
check parse-level invariants (counts, name encodings, weight
normalization), and push the model through build_model -> pose -> physics
-> render end-to-end."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from wild_assets import (build_wild_pmx, build_wild_pmd, build_wild_vmd,
                         N_VERTS, N_TRIS, N_MATS, N_TEXS, N_BONES, N_RIGID,
                         N_JOINTS, IK_DEEP, IK_LINKS, SJIS_TRAPS, HALFWIDTH)
from simple_mmd_renderer.formats import pmx as P
from simple_mmd_renderer.formats.pmd import parse_pmd
from simple_mmd_renderer.formats import vmd as V
from simple_mmd_renderer.core import model as M
from simple_mmd_renderer.core import anim as A
from simple_mmd_renderer.core import physics as PH
from simple_mmd_renderer.core.scene import Scene
from simple_mmd_renderer.config import AppConfig, RenderConfig


@pytest.fixture(params=[False, True], ids=["native", "python"])
def parse(request, monkeypatch):
    if request.param:
        import simple_mmd_renderer.native as native

        def no_native():
            raise RuntimeError("native disabled for test")
        monkeypatch.setattr(native, "get_lib", no_native)
    return P.parse_pmx


def test_wild_pmx_parse_invariants(parse):
    m = parse(build_wild_pmx())
    assert m.name == "ワイルド・モデル（検証用）"
    assert m.extra_uv_count == 2
    assert len(m.positions) == N_VERTS
    assert len(m.triangles) == N_TRIS
    assert len(m.materials) == N_MATS
    assert len(m.textures) == N_TEXS
    assert len(m.bones) == N_BONES
    assert len(m.rigid_bodies) == N_RIGID
    assert len(m.constraints) == N_JOINTS
    assert m.extra_uvs.shape == (N_VERTS, 2, 4)

    # base_shift accumulates across the 120-part table exactly
    shifts = np.array([mat.base_shift for mat in m.materials])
    counts = np.array([mat.n_triangles for mat in m.materials])
    np.testing.assert_array_equal(shifts, np.concatenate(
        [[0], np.cumsum(counts)[:-1]]))
    assert counts.sum() == N_TRIS

    # texture paths survive with backslashes / case / non-ascii intact
    assert m.textures[0] == "tex\\体00.png"
    assert m.textures[1] == "TEX/Body_01.PNG"
    assert any("スフィア/" in t for t in m.textures)

    # global toon references (every even material)
    for i in (0, 2, 50):
        assert m.materials[i].toon_is_global
        assert 0 <= m.materials[i].toon <= 9

    # deep IK chain: bone 30 has 25 links, loop capped at the file's 255
    ik = m.bones[IK_DEEP]
    assert len(ik.ik_links) == IK_LINKS
    assert ik.ik_loop == 255
    # duplicated chain: bone 31 reuses bones 22..27 of bone 30's chain
    ik2 = m.bones[IK_DEEP + 1]
    assert [l.bone for l in ik2.ik_links] == [27, 26, 25, 24, 23, 22]
    shared = {l.bone for l in ik.ik_links} & {l.bone for l in ik2.ik_links}
    assert len(shared) >= 5

    # duplicate bone names exist (wild models alias limbs)
    names = [b.name for b in m.bones]
    assert names.count("腕") >= 2

    # degenerate weights preserved at parse level (Normalize happens later)
    assert m.skin_type[2] == P.BDEF2 and m.skin_weights[2, 0] == 1.0
    assert m.skin_type[4] == P.BDEF4
    np.testing.assert_allclose(m.skin_weights[4].sum(), 1.2, atol=1e-6)


def test_wild_pmx_normalize_demotions(parse):
    """Model::Normalize semantics (model_impl.inl:405-452) at scale: w=1 /
    w=0 BDEF2 demote to BDEF1, SDEF on non-parent-child bones demotes,
    BDEF4 weights are preserved as stored (the reference does not
    renormalize BDEF4)."""
    m = parse(build_wild_pmx())
    static = M.build_model(m)
    st = np.asarray(static.skin_type)
    # vertex k pattern from the builder: i%7==2 -> BDEF2 w=1, 3 -> w=0
    assert st[2] == P.BDEF1 and st[3] == P.BDEF1
    # i%7==5: SDEF on parent-child stays SDEF-like (>= BDEF2 semantics)
    # i%7==6: SDEF on non-adjacent bones must NOT remain SDEF
    assert st[6] != P.SDEF
    # weights renormalized or preserved but FINITE everywhere
    w = np.asarray(static.skin_weights)
    assert np.isfinite(w).all()


def test_wild_pmx_end_to_end_render_and_physics():
    # single (default-parser) variant: the native/python parse agreement is
    # covered by the invariant tests; running the jit pipeline twice would
    # only re-pay ~4 min of CPU compile for identical inputs
    m = P.parse_pmx(build_wild_pmx())
    static = M.build_model(m)
    ps = PH.build_physics(static)
    assert ps.n_bodies == N_RIGID and ps.n_joints == N_JOINTS

    motion = V.parse_vmd(build_wild_vmd())
    mo = A.bind_motion(static, motion)

    cfg = AppConfig()
    cfg.render = RenderConfig(width=96, height=72, shadow_map_size=64,
                              show_skybox=False, raster_mode="scan")
    cfg.physics.solver_iterations = 2
    scene = Scene(static, ps, mo, cfg)
    state = scene.init_state()
    step = scene.jit_step(render=True, donate=False)
    img = None
    for _ in range(3):
        state, img = step(state)
    img = np.asarray(img)
    assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0
    # the blob must actually cover pixels (geometry survived the pipeline)
    clear = np.array([0.1, 0.1, 0.15])
    assert (np.abs(img - clear).sum(-1) > 0.05).mean() > 0.05
    assert np.isfinite(np.asarray(state.physics.pos)).all()


def test_wild_pmd_shiftjis_hazards():
    m = parse_pmd(build_wild_pmd())
    # 0x5C-trail-byte code points decode intact
    assert m.name == "ワイルド" + SJIS_TRAPS[0]
    assert SJIS_TRAPS[1] in m.description and HALFWIDTH in m.description
    names = [b.name for b in m.bones]
    for trap in SJIS_TRAPS:
        assert trap in names
    # english extension applied
    assert m.name_en == "WildPmd"
    assert m.bones[3].name_en == "bone3"
    # toon table consumed, rigid bodies + joints parsed after it
    assert len(m.rigid_bodies) == 3 and len(m.constraints) == 2
    # IK chain attached with PMD semantics (angle x4)
    ik_bones = [b for b in m.bones if b.ik_links]
    assert len(ik_bones) == 1 and len(ik_bones[0].ik_links) == 3
    np.testing.assert_allclose(ik_bones[0].ik_angle, 0.8 * 4.0, atol=1e-6)

    # and it renders
    static = M.build_model(m)
    cfg = AppConfig()
    cfg.render = RenderConfig(width=64, height=48, shadow_map_size=32,
                              show_skybox=False, raster_mode="scan")
    scene = Scene(static, PH.build_physics(static), None, cfg)
    state, img = scene.jit_step(render=True, donate=False)(
        scene.init_state())
    assert np.isfinite(np.asarray(img)).all()


def test_wild_vmd_unsorted_keys_and_junk_names():
    mo = V.parse_vmd(build_wild_vmd())
    # junk after NUL stripped: names resolve exactly
    assert "センター" in mo.bone_tracks
    assert SJIS_TRAPS[0] in mo.bone_tracks
    frames = np.asarray(mo.bone_tracks["センター"].frames)
    # file order was shuffled; parsed track must be sorted
    assert (np.diff(frames) > 0).all()
    np.testing.assert_array_equal(frames, [0, 1, 7, 42, 3000, 100663])
    mf = np.asarray(mo.morph_tracks["まばたき"].frames)
    assert (np.diff(mf) > 0).all() and mf[-1] == 90000
    # the default interpolation bytes presample to the linear ramp
    tr = mo.bone_tracks["センター"]
    np.testing.assert_allclose(tr.c0[0], np.full((4, 2), 20 / 127.0),
                               atol=1e-6)
    np.testing.assert_allclose(tr.c1[0], np.full((4, 2), 107 / 127.0),
                               atol=1e-6)


def test_wild_vmd_sampling_is_finite_everywhere():
    m = parse_pmd(build_wild_pmd())
    static = M.build_model(m)
    mo = A.bind_motion(static, V.parse_vmd(build_wild_vmd()))
    for frame in (0.0, 0.5, 41.9, 42.0, 2999.0, 3000.0, 99999.0, 150000.0):
        rot, trans, rates = A.sample_motion(mo, jnp.float32(frame))
        assert np.isfinite(np.asarray(rot)).all()
        assert np.isfinite(np.asarray(trans)).all()
        assert np.isfinite(np.asarray(rates)).all()
        # quaternions stay normalized through interpolation
        n = np.linalg.norm(np.asarray(rot), axis=-1)
        np.testing.assert_allclose(n, 1.0, atol=1e-4)
