import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simple_mmd_renderer.render import raster
from simple_mmd_renderer.ops import tiled_raster


def _random_mesh(rng, t=200, spread=0.9, z=(0.1, 0.9), size=0.25):
    v0 = rng.uniform(-spread, spread, (t, 2))
    d1 = rng.uniform(-size, size, (t, 2))
    d2 = rng.uniform(-size, size, (t, 2))
    verts = np.stack([v0, v0 + d1, v0 + d2], 1).reshape(-1, 2)
    zs = rng.uniform(*z, (t, 1)).repeat(3, 1).reshape(-1)
    clip = np.concatenate(
        [verts, zs[:, None], np.ones((t * 3, 1))], -1).astype(np.float32)
    tris = np.arange(t * 3, dtype=np.int32).reshape(t, 3)
    return jnp.asarray(clip), jnp.asarray(tris)


def _assert_vis_equal(a: raster.VisBuffer, b: raster.VisBuffer):
    # depth ties between different triangles may pick a different winner only
    # if depths are exactly equal; random z makes that measure-zero
    np.testing.assert_allclose(np.asarray(a.depth), np.asarray(b.depth),
                               atol=2e-5)
    mism = (np.asarray(a.tri) != np.asarray(b.tri)).mean()
    assert mism < 1e-3, f"tri id mismatch ratio {mism}"
    same_tri = np.asarray(a.tri) == np.asarray(b.tri)
    # the tiled kernel evaluates anchored plane equations (like GPU hardware
    # rasterizers) while the scan path computes edge functions from vertex
    # coordinates; both round in f32 at the same order, so a handful of
    # pixels differ by ~1 ulp of the barycentric scale
    np.testing.assert_allclose(np.asarray(a.bary)[same_tri],
                               np.asarray(b.bary)[same_tri], atol=2e-5)


def test_tiled_matches_scan_small_tris():
    rng = np.random.default_rng(0)
    clip, tris = _random_mesh(rng, t=300)
    w, h = 320, 192
    ref = raster.rasterize(clip, tris, w, h, raster.CULL_NONE)
    got = tiled_raster.rasterize_tiled(clip, tris, w, h, raster.CULL_NONE)
    assert (np.asarray(ref.tri) >= 0).mean() > 0.2  # scene has coverage
    _assert_vis_equal(got, ref)


def test_tiled_big_triangle_fallback():
    rng = np.random.default_rng(1)
    clip_s, tris_s = _random_mesh(rng, t=50)
    # one screen-filling triangle behind everything
    big = np.array([[-3, -3, 0.95, 1], [3, -3, 0.95, 1], [0, 3, 0.95, 1]],
                   np.float32)
    clip = jnp.concatenate([clip_s, jnp.asarray(big)])
    tris = jnp.concatenate(
        [tris_s, jnp.asarray([[150, 151, 152]], jnp.int32)])
    w, h = 256, 128
    ref = raster.rasterize(clip, tris, w, h, raster.CULL_NONE)
    got = tiled_raster.rasterize_tiled(clip, tris, w, h, raster.CULL_NONE)
    # the big tri must be visible in the background
    assert (np.asarray(got.tri) == 50).any()
    _assert_vis_equal(got, ref)


def test_tiled_respects_culling():
    rng = np.random.default_rng(2)
    clip, tris = _random_mesh(rng, t=100)
    w, h = 128, 64
    for cull in (raster.CULL_BACK, raster.CULL_FRONT):
        ref = raster.rasterize(clip, tris, w, h, cull)
        got = tiled_raster.rasterize_tiled(clip, tris, w, h, cull)
        _assert_vis_equal(got, ref)


def test_tiled_overflow_cap_graceful():
    # 600 tris piled into one tile with k_max=64: must not crash; nearest
    # surface may be imperfect but depth must be monotone-reasonable
    rng = np.random.default_rng(3)
    clip, tris = _random_mesh(rng, t=600, spread=0.05, size=0.05)
    got = tiled_raster.rasterize_tiled(clip, tris, 128, 64, raster.CULL_NONE,
                                       9)
    assert np.isfinite(np.asarray(got.depth)).all()


def test_tiled_tuned_params_match_scan():
    """A tight bbox cap (e_max=6) stays exact."""
    rng = np.random.default_rng(7)
    clip, tris = _random_mesh(rng, t=250)
    w, h = 256, 128
    ref = raster.rasterize(clip, tris, w, h, raster.CULL_NONE)
    got = tiled_raster.rasterize_tiled(clip, tris, w, h, raster.CULL_NONE,
                                       6)
    _assert_vis_equal(got, ref)


def test_binning_stats_reports_overflow_headroom():
    rng = np.random.default_rng(11)
    clip, tris = _random_mesh(rng, t=150)
    stats = tiled_raster.binning_stats(clip, tris, 256, 128,
                                       raster.CULL_NONE, 6)
    assert stats["big_dropped"] == 0
    assert stats["total_entries"] >= stats["max_tile_entries"] > 0


def test_dense_tile_exceeding_chunk_renders_exactly():
    """Per-tile capacity is unbounded: a tile with hundreds of entries must
    match the scan raster exactly (an early version silently dropped the
    excess over a fixed per-tile capacity)."""
    rng = np.random.default_rng(12)
    clip, tris = _random_mesh(rng, t=500, spread=0.05, size=0.08)
    w, h = 128, 64
    stats = tiled_raster.binning_stats(clip, tris, w, h, raster.CULL_NONE, 6)
    assert stats["max_tile_entries"] > 256, "scene must overload a tile"
    ref = raster.rasterize(clip, tris, w, h, raster.CULL_NONE)
    got = tiled_raster.rasterize_tiled(clip, tris, w, h, raster.CULL_NONE,
                                       6)
    _assert_vis_equal(got, ref)


def test_bench_scene_has_binning_headroom():
    """The flagship sample scene must not silently drop triangles at the
    pipeline's raster parameters (overflow must never be invisible)."""
    import jax.numpy as jnp
    from simple_mmd_renderer.app.sample import sample_character
    from simple_mmd_renderer.core import model as M
    from simple_mmd_renderer.render.pipeline import (_tiled_e_max,
                                                     build_matrices)
    from simple_mmd_renderer.config import RenderConfig

    pm = sample_character(density=0.5)
    static = M.build_model(pm)
    cfg = RenderConfig(width=640, height=360)
    mats = build_matrices(cfg, aspect=640 / 360)
    verts = jnp.asarray(static.positions) * cfg.mmd_to_meter
    tris = jnp.asarray(static.triangles)[:, ::-1]
    clip = raster.transform_clip(verts, mats["mvp"])
    stats = tiled_raster.binning_stats(clip, tris, 640, 360,
                                       raster.CULL_BACK,
                                       _tiled_e_max(640, 360))
    assert stats["big_dropped"] == 0, stats


def test_depth_only_matches_full_tiled():
    """rasterize_depth_tiled (shadow path) == rasterize_tiled().depth,
    including the big-triangle fallback and both cull modes."""
    rng = np.random.default_rng(13)
    clip_s, tris_s = _random_mesh(rng, t=120)
    big = np.array([[-3, -3, 0.95, 1], [3, -3, 0.95, 1], [0, 3, 0.95, 1]],
                   np.float32)
    clip = jnp.concatenate([clip_s, jnp.asarray(big)])
    tris = jnp.concatenate(
        [tris_s, jnp.asarray([[360, 361, 362]], jnp.int32)])
    w, h = 256, 128
    for cull in (raster.CULL_NONE, raster.CULL_FRONT, raster.CULL_BACK):
        ref = tiled_raster.rasterize_tiled(clip, tris, w, h, cull)
        got = tiled_raster.rasterize_depth_tiled(clip, tris, w, h, cull)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref.depth),
                                   atol=2e-5)


def test_depth_only_dense_tile_chunking():
    rng = np.random.default_rng(14)
    clip, tris = _random_mesh(rng, t=400, spread=0.05, size=0.08)
    w, h = 128, 64
    ref = raster.rasterize(clip, tris, w, h, raster.CULL_NONE)
    got = tiled_raster.rasterize_depth_tiled(clip, tris, w, h,
                                             raster.CULL_NONE, 6)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref.depth),
                               atol=2e-5)


def test_covers_all_e_max_handles_giant_tris_without_merge():
    """When e_max >= n_tiles the big-tri fallback is skipped at trace time;
    screen-filling triangles must render exactly through the bins alone."""
    rng = np.random.default_rng(15)
    clip_s, tris_s = _random_mesh(rng, t=60)
    big = np.array([[-3, -3, 0.95, 1], [3, -3, 0.95, 1], [0, 3, 0.95, 1]],
                   np.float32)
    clip = jnp.concatenate([clip_s, jnp.asarray(big)])
    tris = jnp.concatenate(
        [tris_s, jnp.asarray([[180, 181, 182]], jnp.int32)])
    w, h = 256, 128
    n_tiles = tiled_raster._grid(w, h)[1]
    assert tiled_raster._covers_all(n_tiles, w, h)
    ref = raster.rasterize(clip, tris, w, h, raster.CULL_NONE)
    got = tiled_raster.rasterize_tiled(clip, tris, w, h, raster.CULL_NONE,
                                       n_tiles)
    _assert_vis_equal(got, ref)
    gotd = tiled_raster.rasterize_depth_tiled(clip, tris, w, h,
                                              raster.CULL_NONE, n_tiles)
    np.testing.assert_allclose(np.asarray(gotd), np.asarray(ref.depth),
                               atol=2e-5)


def test_big_tri_merge_still_active_at_large_targets():
    """At targets larger than the covers-all threshold the scan fallback
    still merges oversized triangles exactly."""
    rng = np.random.default_rng(16)
    clip_s, tris_s = _random_mesh(rng, t=40)
    big = np.array([[-3, -3, 0.95, 1], [3, -3, 0.95, 1], [0, 3, 0.95, 1]],
                   np.float32)
    clip = jnp.concatenate([clip_s, jnp.asarray(big)])
    tris = jnp.concatenate(
        [tris_s, jnp.asarray([[120, 121, 122]], jnp.int32)])
    w, h = 384, 256  # far more tiles than e_max=6 -> merge path live
    assert not tiled_raster._covers_all(6, w, h)
    ref = raster.rasterize(clip, tris, w, h, raster.CULL_NONE)
    got = tiled_raster.rasterize_tiled(clip, tris, w, h, raster.CULL_NONE,
                                       6)
    assert (np.asarray(got.tri) == 40).any()
    _assert_vis_equal(got, ref)


def _shift_clip(clip, ox, oy, w, h):
    """Clip-space translation that moves the pixel-center sample grid onto
    the (ox, oy)-offset sample positions (y is screen-down)."""
    c = np.asarray(clip).copy()
    c[:, 0] -= (2.0 * ox / w) * c[:, 3]
    c[:, 1] += (2.0 * oy / h) * c[:, 3]
    return jnp.asarray(c)


def test_msaa_per_sample_depth_matches_shifted_scan():
    rng = np.random.default_rng(17)
    clip, tris = _random_mesh(rng, t=160)
    attrs = jnp.asarray(rng.uniform(0, 1, (clip.shape[0], 3)).astype(
        np.float32))
    w, h = 256, 128
    vis, attr, sdepth = tiled_raster.rasterize_attrs_tiled_msaa(
        clip, tris, attrs, w, h, raster.CULL_NONE)
    for s, (ox, oy) in enumerate(tiled_raster.MSAA4_OFFSETS):
        ref = raster.rasterize(_shift_clip(clip, ox, oy, w, h), tris, w, h,
                               raster.CULL_NONE)
        ref_cov = np.asarray(ref.tri) >= 0
        got_cov = np.asarray(sdepth[s]) < 1.0 - 1e-7
        assert (ref_cov != got_cov).mean() < 2e-3, f"sample {s} coverage"
        both = ref_cov & got_cov
        np.testing.assert_allclose(np.asarray(sdepth[s])[both],
                                   np.asarray(ref.depth)[both], atol=3e-5)


def test_msaa_center_visibility_supersets_standard():
    """Where the standard center raster has coverage, the MSAA kernel's
    center visibility must agree exactly (its extra any-sample coverage only
    ADDS edge pixels)."""
    rng = np.random.default_rng(18)
    clip, tris = _random_mesh(rng, t=120)
    attrs = jnp.asarray(rng.uniform(0, 1, (clip.shape[0], 2)).astype(
        np.float32))
    w, h = 256, 128
    ref_vis, ref_attr = tiled_raster.rasterize_attrs_tiled(
        clip, tris, attrs, w, h, raster.CULL_NONE)
    vis, attr, _ = tiled_raster.rasterize_attrs_tiled_msaa(
        clip, tris, attrs, w, h, raster.CULL_NONE)
    cov = np.asarray(ref_vis.tri) >= 0
    # residual mismatches are pixels whose center-covering triangle hits no
    # sample (correct MSAA semantics: invisible to sample-based raster, so
    # another sample-covered triangle fills the pixel's attributes)
    assert (np.asarray(vis.tri)[cov] == np.asarray(ref_vis.tri)[cov]).mean() \
        > 0.99
    same = cov & (np.asarray(vis.tri) == np.asarray(ref_vis.tri))
    np.testing.assert_allclose(np.asarray(vis.depth)[same],
                               np.asarray(ref_vis.depth)[same], atol=2e-5)
    np.testing.assert_allclose(np.asarray(attr)[same],
                               np.asarray(ref_attr)[same], atol=2e-4)
    # near-superset: a center-covered pixel goes empty only when its
    # triangle hits none of the 4 samples (sample-based raster semantics)
    assert (np.asarray(vis.tri)[cov] >= 0).mean() > 0.99


def test_crowd_fused_raster_matches_per_instance():
    """The fused multi-instance raster must equal the single-instance tiled
    raster run per instance (same covers-all binning)."""
    rng = np.random.default_rng(21)
    n_inst, w, h = 3, 256, 128
    n_tiles = tiled_raster._grid(w, h)[1]
    clips, attrs = [], []
    for _ in range(n_inst):
        c, tris = _random_mesh(rng, t=80)
        clips.append(np.asarray(c))
        attrs.append(rng.uniform(0, 1, (c.shape[0], 3)).astype(np.float32))
    clip_b = jnp.asarray(np.stack(clips))
    attr_b = jnp.asarray(np.stack(attrs))
    vis, attr = tiled_raster.rasterize_attrs_tiled_crowd(
        clip_b, tris, attr_b, w, h, raster.CULL_NONE)
    for i in range(n_inst):
        ref_vis, ref_attr = tiled_raster.rasterize_attrs_tiled(
            clip_b[i], tris, attr_b[i], w, h, raster.CULL_NONE, n_tiles)
        np.testing.assert_allclose(np.asarray(vis.depth[i]),
                                   np.asarray(ref_vis.depth), atol=2e-5)
        assert (np.asarray(vis.tri[i]) != np.asarray(ref_vis.tri)).mean() \
            < 1e-3
        same = np.asarray(vis.tri[i]) == np.asarray(ref_vis.tri)
        np.testing.assert_allclose(np.asarray(attr[i])[same],
                                   np.asarray(ref_attr)[same], atol=2e-4)


def test_crowd_fused_depth_matches_per_instance():
    rng = np.random.default_rng(22)
    n_inst, w, h = 3, 128, 128
    clips = []
    for _ in range(n_inst):
        c, tris = _random_mesh(rng, t=60)
        clips.append(np.asarray(c))
    clip_b = jnp.asarray(np.stack(clips))
    for cull in (raster.CULL_NONE, raster.CULL_FRONT):
        depth = tiled_raster.rasterize_depth_tiled_crowd(
            clip_b, tris, w, h, cull)
        for i in range(n_inst):
            ref = tiled_raster.rasterize_depth_tiled(
                clip_b[i], tris, w, h, cull, 4)
            np.testing.assert_allclose(np.asarray(depth[i]),
                                       np.asarray(ref), atol=2e-5)


def test_crowd_compaction_mostly_culled():
    """The validity-compacted crowd binning (CROWD_COMPACT_DIV passes,
    later ones cond-skipped) must stay exact when most triangles are
    culled — the crowd regime it exists for — including instances that are
    entirely offscreen, and when every pass fires (all-valid scenes are
    covered by the other crowd tests)."""
    rng = np.random.default_rng(31)
    n_inst, w, h = 4, 256, 128
    clips, attrs = [], []
    for k in range(n_inst):
        c, tris = _random_mesh(rng, t=100)
        c = np.array(c)
        if k == 1:
            c[:, 0] += 10.0          # entirely offscreen
        if k == 3:
            c[:, 2] = -5.0           # entirely behind the depth range
        clips.append(c)
        attrs.append(rng.uniform(0, 1, (c.shape[0], 2)).astype(np.float32))
    clip_b = jnp.asarray(np.stack(clips))
    attr_b = jnp.asarray(np.stack(attrs))
    vis, attr = tiled_raster.rasterize_attrs_tiled_crowd(
        clip_b, tris, attr_b, w, h, raster.CULL_NONE)
    assert (np.asarray(vis.tri[1]) == -1).all()
    for i in (0, 2):
        ref_vis, ref_attr = tiled_raster.rasterize_attrs_tiled(
            clip_b[i], tris, attr_b[i], w, h, raster.CULL_NONE, 8)
        np.testing.assert_allclose(np.asarray(vis.depth[i]),
                                   np.asarray(ref_vis.depth), atol=2e-5)
        same = np.asarray(vis.tri[i]) == np.asarray(ref_vis.tri)
        assert (~same).mean() < 1e-3
        np.testing.assert_allclose(np.asarray(attr[i])[same],
                                   np.asarray(ref_attr)[same], atol=2e-4)


def test_packed_sort_paths_agree():
    """The int32 single-key fast path and the lexicographic two-key fallback
    must produce identical segment tables (r2 VERDICT #3: the fixed 18-bit
    key capped triangles at 262144)."""
    rng = np.random.default_rng(11)
    n_seg = 37
    tile = jnp.asarray(rng.integers(0, n_seg + 1, 5000), jnp.int32)
    tri = jnp.asarray(rng.permutation(5000), jnp.int32)
    ref_order = np.lexsort((np.asarray(tri), np.asarray(tile)))
    ref_tri = np.asarray(tri)[ref_order]
    # i32 fast path (t=5000 -> 13 tri bits, plenty of headroom)
    got_tri, start = tiled_raster._packed_sort(tile, tri, 5000, n_seg)
    np.testing.assert_array_equal(np.asarray(got_tri), ref_tri)
    # force the fallback: a pretended t of 2^29 leaves no room for segments
    got2_tri, start2 = tiled_raster._packed_sort(tile, tri, 1 << 29, n_seg)
    np.testing.assert_array_equal(np.asarray(got2_tri), ref_tri)
    np.testing.assert_array_equal(np.asarray(start), np.asarray(start2))
    counts = np.asarray(start)[1:] - np.asarray(start)[:-1]
    np.testing.assert_array_equal(
        counts, np.bincount(np.asarray(tile), minlength=n_seg + 1)[:n_seg])


def test_tiled_beyond_262k_triangles():
    """A mesh past the old 2^18 packed-key ceiling rasterizes exactly: 300k
    triangles (mostly degenerate pad) must match the same scene with only
    its live triangles."""
    rng = np.random.default_rng(12)
    clip_s, tris_s = _random_mesh(rng, t=40)
    w, h = 256, 64
    ref = tiled_raster.rasterize_tiled(clip_s, tris_s, w, h,
                                       raster.CULL_NONE)
    t_total = 300_000
    # live triangles first, degenerate (zero-area, culled in setup) padding
    # referencing vertex 0 after them
    pad = jnp.zeros((t_total - 40, 3), jnp.int32)
    tris = jnp.concatenate([tris_s, pad])
    got = tiled_raster.rasterize_tiled(clip_s, tris, w, h, raster.CULL_NONE)
    assert (np.asarray(ref.tri) >= 0).mean() > 0.1
    _assert_vis_equal(got, ref)


def test_crowd_big_triangle_fallback():
    """Fused crowd binning is bbox-limited (r3: covers-all OOM'd at dense
    crowds); a screen-filling triangle in ONE instance must still render
    exactly via the capped per-instance scan fallback — in the attr, msaa,
    and depth crowd paths."""
    rng = np.random.default_rng(33)
    n_inst, w, h = 3, 384, 128
    n_tiles = tiled_raster._grid(w, h)[1]
    assert tiled_raster._crowd_e_max(w, h) < n_tiles
    clips, attrs = [], []
    for k in range(n_inst):
        c, tris = _random_mesh(rng, t=40)
        c = np.array(c)
        if k == 1:  # instance 1 gets a screen-filling triangle (tri 0)
            c[0] = [-2.0, -2.0, 0.05, 1.0]
            c[1] = [4.0, -2.0, 0.05, 1.0]
            c[2] = [-2.0, 4.0, 0.05, 1.0]
        clips.append(c)
        attrs.append(rng.uniform(0, 1, (c.shape[0], 3)).astype(np.float32))
    clip_b = jnp.asarray(np.stack(clips))
    attr_b = jnp.asarray(np.stack(attrs))

    vis, attr = tiled_raster.rasterize_attrs_tiled_crowd(
        clip_b, tris, attr_b, w, h, raster.CULL_NONE)
    # the giant triangle wins everywhere it is closest; specifically the
    # whole frame of instance 1 is covered
    assert (np.asarray(vis.tri[1]) >= 0).all()
    for i in range(n_inst):
        ref_vis, ref_attr = tiled_raster.rasterize_attrs_tiled(
            clip_b[i], tris, attr_b[i], w, h, raster.CULL_NONE, n_tiles)
        np.testing.assert_allclose(np.asarray(vis.depth[i]),
                                   np.asarray(ref_vis.depth), atol=2e-5)
        assert (np.asarray(vis.tri[i]) != np.asarray(ref_vis.tri)).mean() \
            < 1e-3

    depth = tiled_raster.rasterize_depth_tiled_crowd(
        clip_b, tris, w, h, raster.CULL_NONE)
    for i in range(n_inst):
        ref = tiled_raster.rasterize_depth_tiled(
            clip_b[i], tris, w, h, raster.CULL_NONE, n_tiles)
        np.testing.assert_allclose(np.asarray(depth[i]), np.asarray(ref),
                                   atol=2e-5)

    vis_m, attr_m, sdepth = tiled_raster.rasterize_attrs_tiled_msaa_crowd(
        clip_b, tris, attr_b, w, h, raster.CULL_NONE)
    ref_vis, ref_attr, ref_sd = tiled_raster.rasterize_attrs_tiled_msaa(
        clip_b[1], tris, attr_b[1], w, h, raster.CULL_NONE, n_tiles)
    np.testing.assert_allclose(np.asarray(vis_m.depth[1]),
                               np.asarray(ref_vis.depth), atol=2e-5)
    assert (np.asarray(sdepth[1]) < 1.0).all()  # all samples hit


def test_prefix_compaction_bit_exact():
    """Validity-compacted prefix binning (_bin_prefix: one id sort + a
    lax.switch over static prefix rungs) must be BIT-exact vs the
    uncompacted bin on every single-instance entry point — same kernel,
    same rows, only fewer pad slots. Covers the mid rung (random culled
    fraction), the smallest rung (mostly offscreen), the full-T rung
    (nothing culled), tiny single-tile triangles and large multi-tile ones
    (which also exercise the big-tri merge)."""
    import jax

    rng = np.random.default_rng(47)
    w, h = 256, 160
    t = tiled_raster.COMPACT_MIN_T + 500

    def variants():
        clip, tris = _random_mesh(rng, t=t, size=0.12)
        yield clip, tris, raster.CULL_BACK      # ~half culled -> mid rung
        yield clip, tris, raster.CULL_NONE      # all valid -> full rung
        c = np.array(clip)
        c[: 3 * (t - 64), 0] += 10.0            # mostly offscreen -> rung 0
        yield jnp.asarray(c), tris, raster.CULL_NONE
        # tiny triangles: every valid one covers ONE tile (multis rung 0)
        clip2, tris2 = _random_mesh(rng, t=t, size=0.01)
        yield clip2, tris2, raster.CULL_BACK
        # large triangles: most cover many tiles (multis past the first
        # rung -> full-T multis window; also exercises the big-tri merge)
        clip3, tris3 = _random_mesh(rng, t=t, size=0.45)
        yield clip3, tris3, raster.CULL_BACK

    for clip, tris, cull in variants():
        attrs = jnp.asarray(
            rng.uniform(0, 1, (clip.shape[0], 3)).astype(np.float32))
        for fn in (
            lambda c: tiled_raster.rasterize_attrs_tiled(
                clip, tris, attrs, w, h, cull, compact=c),
            lambda c: tiled_raster.rasterize_depth_tiled(
                clip, tris, w, h, cull, compact=c),
            lambda c: tiled_raster.rasterize_attrs_tiled_msaa(
                clip, tris, attrs, w, h, cull, compact=c),
        ):
            got = jax.tree.leaves(fn(True))
            ref = jax.tree.leaves(fn(False))
            for a, b in zip(got, ref):
                assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("w,h", [(100, 70), (33, 65), (257, 31)])
def test_non_tile_multiple_sizes_match_scan(w, h):
    """Frames whose sides are not tile multiples: the padded edge tiles are
    cropped away and every visible pixel matches the scan raster, for the
    visibility, attribute, depth-only and MSAA variants."""
    assert w % tiled_raster.TILE_W or h % tiled_raster.TILE_H
    rng = np.random.default_rng(5)
    clip, tris = _random_mesh(rng, t=150)
    attrs = jnp.asarray(rng.uniform(0, 1, (clip.shape[0], 3)).astype(
        np.float32))
    ref = raster.rasterize(clip, tris, w, h, raster.CULL_NONE)
    got = tiled_raster.rasterize_tiled(clip, tris, w, h, raster.CULL_NONE)
    assert got.depth.shape == (h, w)
    _assert_vis_equal(got, ref)
    vis, attr = tiled_raster.rasterize_attrs_tiled(clip, tris, attrs, w, h,
                                                   raster.CULL_NONE)
    assert attr.shape == (h, w, 3)
    _assert_vis_equal(vis, ref)
    ref_attr = raster.interpolate(ref, clip, tris, attrs)
    same = np.asarray(vis.tri) == np.asarray(ref.tri)
    np.testing.assert_allclose(np.asarray(attr)[same],
                               np.asarray(ref_attr)[same], atol=2e-4)
    depth = tiled_raster.rasterize_depth_tiled(clip, tris, w, h,
                                               raster.CULL_NONE)
    np.testing.assert_allclose(np.asarray(depth), np.asarray(ref.depth),
                               atol=2e-5)
    _, _, sdepth = tiled_raster.rasterize_attrs_tiled_msaa(
        clip, tris, attrs, w, h, raster.CULL_NONE)
    assert sdepth.shape == (4, h, w)


@pytest.mark.parametrize("backend,expect", [
    ("cpu", True), ("gpu", False), ("rocm", NotImplementedError)])
def test_interpret_mode_backend_rule(monkeypatch, backend, expect):
    """The kernel interprets on the CPU, compiles on the GPU and refuses
    any other backend."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if expect is NotImplementedError:
        with pytest.raises(NotImplementedError):
            tiled_raster._interpret()
    else:
        assert tiled_raster._interpret() is expect


@pytest.mark.parametrize("mode,backend,expect", [
    ("auto", "gpu", "tiled"), ("auto", "cpu", "scan"),
    ("auto", "rocm", NotImplementedError), ("tiled", "cpu", "tiled"),
    ("scan", "gpu", "scan"), ("bogus", "gpu", ValueError)])
def test_pick_raster_backend_rule(monkeypatch, mode, backend, expect):
    from simple_mmd_renderer.config import RenderConfig
    from simple_mmd_renderer.render import pipeline
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cfg = RenderConfig(raster_mode=mode)
    if isinstance(expect, type):
        with pytest.raises(expect):
            pipeline._pick_raster(cfg)
        return
    want = (tiled_raster.rasterize_tiled if expect == "tiled"
            else raster.rasterize)
    assert pipeline._pick_raster(cfg) is want


@pytest.mark.parametrize("kw", [
    dict(depth_only=True), dict(), dict(n_attrs=3), dict(n_attrs=5),
    dict(n_attrs=3, samples=4)], ids=["depth", "vis", "attrs3", "attrs5",
                                      "msaa"])
def test_kernel_lowers_for_gpu(monkeypatch, kw):
    """Every kernel variant lowers through Pallas' Triton route for CUDA
    (the lowering runs here; only the PTX compile needs the card): block
    shapes, scalar loads and the dynamic-trip loop are all accepted."""
    monkeypatch.setattr(tiled_raster, "_interpret", lambda: False)
    n_inst, w, h = 2, 100, 70
    n = n_inst * tiled_raster._grid(w, h)[1]
    row_w = 32 if kw.get("n_attrs") else 16
    args = (jnp.zeros((64, row_w), jnp.float32), jnp.zeros((n,), jnp.int32),
            jnp.zeros((n,), jnp.int32))
    fn = jax.jit(lambda r, s, c: tiled_raster._run_tiles(
        r, s, c, n_inst, w, h, **kw))
    text = fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" in text


@pytest.mark.gpu
def test_kernel_matches_scan_on_gpu(gpu):
    """The compiled kernel (not interpret mode) agrees with the scan raster
    on the card, visibility and depth-only variants."""
    assert not tiled_raster._interpret()
    rng = np.random.default_rng(41)
    clip, tris = _random_mesh(rng, t=400)
    w, h = 320, 192
    ref = raster.rasterize(clip, tris, w, h, raster.CULL_NONE)
    _assert_vis_equal(
        tiled_raster.rasterize_tiled(clip, tris, w, h, raster.CULL_NONE), ref)
    np.testing.assert_allclose(
        np.asarray(tiled_raster.rasterize_depth_tiled(clip, tris, w, h,
                                                      raster.CULL_NONE)),
        np.asarray(ref.depth), atol=2e-5)
