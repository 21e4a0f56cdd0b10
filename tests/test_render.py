import numpy as np
import pytest
import jax.numpy as jnp

from simple_mmd_renderer.render import raster, camera as cam, shade, ibl
from simple_mmd_renderer.render.pipeline import render_frame
from simple_mmd_renderer.config import RenderConfig
from simple_mmd_renderer.core import model as M
from simple_mmd_renderer.formats import pmx as P

from fixtures import two_bone_arm


def ndc_tri(verts2d, z=0.5):
    """Clip coords for screen-filling test triangles (w=1)."""
    v = np.asarray(verts2d, np.float32)
    out = np.zeros((len(v), 4), np.float32)
    out[:, :2] = v
    out[:, 2] = z
    out[:, 3] = 1.0
    return jnp.asarray(out)


def test_rasterize_single_triangle_coverage():
    # CCW-visual (front in y-down raster = negative area): large triangle
    clip = ndc_tri([[-0.9, -0.9], [0.9, -0.9], [0.0, 0.9]])
    # bottom-left -> bottom-right -> top: CCW on screen = front (area2 < 0)
    tris = jnp.array([[0, 1, 2]], jnp.int32)
    vis = raster.rasterize(clip, tris, 64, 64, raster.CULL_BACK)
    cover = np.asarray(vis.tri >= 0)
    assert cover[32, 32]           # center covered
    assert not cover[2, 2]         # corners empty
    assert not cover[2, 61]
    # flip culling: nothing drawn
    vis2 = raster.rasterize(clip, tris, 64, 64, raster.CULL_FRONT)
    assert not np.asarray(vis2.tri >= 0).any()
    # CULL_NONE draws either winding
    vis3 = raster.rasterize(clip, tris[:, ::-1], 64, 64, raster.CULL_NONE)
    assert np.asarray(vis3.tri >= 0)[32, 32]


def test_rasterize_depth_order():
    near = ndc_tri([[-0.9, -0.9], [0.9, -0.9], [0.0, 0.9]], z=0.2)
    far = ndc_tri([[-0.9, -0.9], [0.9, -0.9], [0.0, 0.9]], z=0.8)
    clip = jnp.concatenate([near, far])
    tris = jnp.array([[0, 1, 2], [3, 4, 5]], jnp.int32)
    vis = raster.rasterize(clip, tris, 32, 32, raster.CULL_BACK)
    assert int(vis.tri[16, 16]) == 0
    # draw order flipped: near still wins
    tris2 = jnp.array([[3, 4, 5], [0, 1, 2]], jnp.int32)
    vis2 = raster.rasterize(clip, tris2, 32, 32, raster.CULL_BACK)
    np.testing.assert_allclose(float(vis2.depth[16, 16]), 0.2, atol=1e-5)


def test_interpolate_perspective_correct():
    # quad edge-on-ish: vertex at w=1 and w=4; midpoint of the screen-space
    # segment must be biased toward the near vertex's attribute
    clip = jnp.array([[-0.5, -0.5, 0.5, 1.0],
                      [2.0, -0.5, 0.5, 4.0],
                      [-0.5, 0.5, 0.5, 1.0]], jnp.float32)
    tris = jnp.array([[0, 2, 1]], jnp.int32)
    vis = raster.rasterize(clip, tris, 64, 64, raster.CULL_NONE)
    attr = jnp.array([[0.0], [1.0], [0.0]], jnp.float32)
    out = raster.interpolate(vis, clip, tris, attr)
    ys, xs = np.where(np.asarray(vis.tri) >= 0)
    row = ys[len(ys) // 2]
    vals = np.asarray(out[row, :, 0])
    cov = np.asarray(vis.tri[row] >= 0)
    mid = vals[cov]
    # screen-space lerp would give ~linear ramp; perspective-correct is convex
    # (values below the linear ramp toward the far vertex)
    n = len(mid)
    if n > 8:
        lin = np.linspace(mid[0], mid[-1], n)
        assert (mid[1:-1] <= lin[1:-1] + 1e-3).all()
        assert mid[1:-1].mean() < lin[1:-1].mean() - 0.01


def test_camera_matrices():
    view = cam.look_at(jnp.array([0.0, 0, 5]), jnp.zeros(3),
                       jnp.array([0.0, 1, 0]))
    p = view @ jnp.array([0.0, 0, 0, 1])
    np.testing.assert_allclose(p[:3], [0, 0, -5], atol=1e-6)
    proj = cam.perspective(jnp.deg2rad(90.0), 1.0, 0.1, 100.0)
    clip = proj @ p
    ndc = clip[:3] / clip[3]
    assert 0.0 <= float(ndc[2]) <= 1.0
    # point at the near plane maps to z=0, far to z=1 (RH_ZO)
    near_clip = proj @ jnp.array([0.0, 0, -0.1, 1])
    np.testing.assert_allclose(float(near_clip[2] / near_clip[3]), 0.0, atol=1e-6)
    far_clip = proj @ jnp.array([0.0, 0, -100.0, 1])
    np.testing.assert_allclose(float(far_clip[2] / far_clip[3]), 1.0, atol=1e-5)


def test_srgb_roundtrip():
    x = jnp.linspace(0.0, 1.0, 64)
    y = shade.linear_to_srgb(shade.srgb_to_linear(x))
    np.testing.assert_allclose(y, x, atol=1e-5)


def test_cubemap_roundtrip():
    # equirect whose color encodes direction; convert + sample back
    h, w = 64, 128
    # the conversion inverse maps u = atan2(z,x)/2pi + 0.5 (main.cpp:1131-34)
    theta = ((np.arange(w) + 0.5) / w - 0.5) * 2 * np.pi
    phi = (np.arange(h) + 0.5) / h * np.pi
    dirs = np.stack(np.broadcast_arrays(
        np.cos(theta)[None, :] * np.sin(phi)[:, None],
        np.cos(phi)[:, None] * np.ones(w)[None, :],
        np.sin(theta)[None, :] * np.sin(phi)[:, None]), -1)
    equirect = (dirs * 0.5 + 0.5).astype(np.float32)
    cube = ibl.equirect_to_cubemap(jnp.asarray(equirect), size=64)

    rng = np.random.default_rng(0)
    d = rng.standard_normal((256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = np.asarray(ibl.sample_cubemap(cube, jnp.asarray(d)))
    expect = d * 0.5 + 0.5
    # nearest sampling at 64px faces: generous tolerance
    assert np.abs(got - expect).max() < 0.15
    assert np.abs(got - expect).mean() < 0.03


def _sphere_model(radius=5.0, center=(0.0, 10.0, 0.0), n=12):
    pm = two_bone_arm()
    us, vs = np.meshgrid(np.linspace(0, 2 * np.pi, 2 * n, endpoint=False),
                         np.linspace(0.12, np.pi - 0.12, n), indexing="ij")
    pts = np.stack([np.sin(vs) * np.cos(us), np.cos(vs),
                    np.sin(vs) * np.sin(us)], -1).reshape(-1, 3)
    verts = (pts * radius + np.asarray(center)).astype(np.float32)
    tris = []
    for i in range(2 * n):
        for j in range(n - 1):
            a = i * n + j
            b = ((i + 1) % (2 * n)) * n + j
            tris += [[a, b, a + 1], [b, b + 1, a + 1]]
    nv = len(verts)
    pm.positions = verts
    pm.normals = pts.reshape(-1, 3).astype(np.float32)
    pm.uvs = np.zeros((nv, 2), np.float32)
    pm.extra_uvs = np.zeros((nv, 0, 4), np.float32)
    pm.skin_type = np.full(nv, P.BDEF1, np.uint8)
    pm.skin_bones = np.tile(np.array([[0, -1, -1, -1]], np.int32), (nv, 1))
    pm.skin_weights = np.tile(np.array([[1, 0, 0, 0]], np.float32), (nv, 1))
    pm.sdef_c = np.zeros((nv, 3), np.float32)
    pm.sdef_r0 = np.zeros((nv, 3), np.float32)
    pm.sdef_r1 = np.zeros((nv, 3), np.float32)
    pm.edge_scale = np.ones(nv, np.float32)
    pm.triangles = np.asarray(tris, np.int32)
    pm.morphs = []
    pm.materials = [pm.materials[0]]
    pm.materials[0].n_triangles = len(tris)
    pm.materials[0].texture = -1
    return M.build_model(pm)


def test_full_frame_sphere_over_ground():
    static = _sphere_model()
    cfg = RenderConfig(width=160, height=120, shadow_map_size=256,
                       show_skybox=False)
    img = np.asarray(render_frame(
        static, jnp.asarray(static.positions), jnp.asarray(static.normals),
        cfg))
    assert img.shape == (120, 160, 3)
    assert np.isfinite(img).all()
    # sphere (1m ball at y=1) should cover the image center region
    center = img[40:70, 60:100]
    clear = np.asarray(cfg.clear_color)
    assert (np.abs(center - clear).sum(-1) > 0.05).mean() > 0.5
    # ground visible at the bottom, lit value = 0.7 after PCF
    bottom = img[115:, :]
    assert (np.abs(bottom - 0.7).max(-1) < 0.02).mean() > 0.3
    # shadow: some ground pixels are significantly darker than 0.7
    ground_like = np.abs(img.max(-1) - img.min(-1)) < 1e-3  # grey pixels
    greys = img[..., 0][ground_like]
    assert (greys < 0.4).any(), "expected a cast shadow on the ground"


def test_frame_with_skybox():
    static = _sphere_model()
    equirect = np.ones((8, 16, 3), np.float32) * np.array([4.0, 0.0, 0.0])
    cube = ibl.equirect_to_cubemap(jnp.asarray(equirect), size=16)
    cfg = RenderConfig(width=64, height=48, shadow_map_size=64,
                       show_ground=False)
    img = np.asarray(render_frame(
        static, jnp.asarray(static.positions), jnp.asarray(static.normals),
        cfg, cubemap=cube))
    # background = ACES(4.0) red, strongly red everywhere off-sphere
    corner = img[0, 0]
    assert corner[0] > 0.8 and corner[1] < 0.1


def test_ground_lit_map_matches_pcf():
    """Shadow-space PCF (fast path) vs per-pixel PCF (reference semantics)."""
    import jax.numpy as jnp
    from simple_mmd_renderer.render.pipeline import (build_matrices,
                                                         ground_pass,
                                                         shadow_pass)
    static = _sphere_model()
    cfg = RenderConfig(width=96, height=64, shadow_map_size=256,
                       show_skybox=False)
    mats = build_matrices(cfg)
    verts = jnp.asarray(static.positions) * 0.1
    tris = jnp.asarray(static.triangles)[:, ::-1]
    shadow_map = shadow_pass(verts, tris, mats["light_mvp"], 256)
    mask, gpos, _ = ground_pass(cfg, mats["view"], mats["proj"], 96, 64)
    light_px = raster.transform_clip(gpos.reshape(-1, 3),
                                     mats["light_vp"]).reshape(64, 96, 4)
    exact = shade.pcf_shadow(light_px, shadow_map, jnp.asarray(True))[..., 0]
    lit_map = shade.ground_lit_map(shadow_map, mats["light_vp"])
    fast = shade.ground_shadow_lookup(light_px, lit_map,
                                      jnp.asarray(True))[..., 0]
    m = np.asarray(mask)
    diff = np.abs(np.asarray(exact) - np.asarray(fast))[m]
    assert diff.mean() < 0.03, diff.mean()
    assert (diff > 0.34).mean() < 0.02  # isolated texel-quantization pixels
    # both see an actual shadow
    assert (np.asarray(exact)[m] < 0.5).any()
    assert (np.asarray(fast)[m] < 0.5).any()


def test_msaa_supersampling():
    static = _sphere_model(n=8)
    cfg = RenderConfig(width=64, height=48, shadow_map_size=64,
                       show_skybox=False, msaa=4)
    img = np.asarray(render_frame(
        static, jnp.asarray(static.positions), jnp.asarray(static.normals),
        cfg))
    assert img.shape == (48, 64, 3)
    cfg1 = RenderConfig(width=64, height=48, shadow_map_size=64,
                        show_skybox=False, msaa=1)
    img1 = np.asarray(render_frame(
        static, jnp.asarray(static.positions), jnp.asarray(static.normals),
        cfg1))
    # same scene, antialiased edges: small mean difference, nonzero variance
    assert np.abs(img - img1).mean() < 0.05
    assert np.abs(img - img1).max() > 0.01


def test_msaa_native_kernel_path():
    """True per-sample MSAA (tiled kernel) vs single-sample and vs the
    supersample emulation: close overall, antialiased at edges."""
    static = _sphere_model(n=8)
    base = dict(width=64, height=48, shadow_map_size=64, show_skybox=False,
                raster_mode="tiled")
    args = (static, jnp.asarray(static.positions),
            jnp.asarray(static.normals))
    img_native = np.asarray(render_frame(
        *args, RenderConfig(msaa=4, **base)))
    img_ss = np.asarray(render_frame(
        *args, RenderConfig(msaa=4, msaa_supersample=True, **base)))
    img_1 = np.asarray(render_frame(*args, RenderConfig(msaa=1, **base)))
    assert img_native.shape == (48, 64, 3)
    assert np.isfinite(img_native).all()
    # both AA modes stay near the aliased image overall...
    assert np.abs(img_native - img_1).mean() < 0.05
    # ...and the native path produces fractional edge coverage: pixels
    # strictly between the background and the character intensity
    d = np.abs(img_native - img_1).max(-1)
    assert (d > 0.02).any(), "native MSAA changed no edge pixels"
    # native and supersample agree closely where both are interior
    assert np.abs(img_native - img_ss).mean() < 0.06


def test_edge_outline_pass():
    """show_edges draws the inverted-hull outline in the material's edge
    color around the silhouette, under the character."""
    from simple_mmd_renderer.formats import pmx as P

    static = _sphere_model(n=10)
    static.materials[0].draw_flags |= P.MAT_DRAW_EDGE
    static.materials[0].edge_size = 4.0
    static.materials[0].edge_color = np.array([1, 0, 0, 1], np.float32)
    # rebuild edge tables the way build_model does (fixture shortcut)
    tri = static.triangles
    static.edge_tris = tri.copy()
    static.edge_tri_part = np.zeros(len(tri), np.int32)
    static.edge_colors = np.array([[1, 0, 0, 1]], np.float32)
    static.edge_mag = np.full(len(static.positions), 4.0, np.float32)

    base_cfg = dict(width=96, height=72, shadow_map_size=64,
                    show_skybox=False)
    args = (static, jnp.asarray(static.positions),
            jnp.asarray(static.normals))
    img_off = np.asarray(render_frame(*args, RenderConfig(**base_cfg)))
    img_on = np.asarray(render_frame(
        *args, RenderConfig(show_edges=True, edge_scale=30.0, **base_cfg)))
    # red outline pixels appear only with edges on
    red = (img_on[..., 0] > 0.8) & (img_on[..., 1] < 0.2) \
        & (img_on[..., 2] < 0.2)
    red_off = (img_off[..., 0] > 0.8) & (img_off[..., 1] < 0.2) \
        & (img_off[..., 2] < 0.2)
    assert red.sum() > 20, f"outline missing ({red.sum()} px)"
    assert red_off.sum() == 0
    # character interior unchanged (outline is under the character)
    char = np.abs(img_off - np.asarray(RenderConfig().clear_color)).sum(-1) \
        > 0.05
    interior = char.copy()
    interior[:, :] = False
    interior[30:40, 44:52] = char[30:40, 44:52]
    np.testing.assert_allclose(img_on[interior], img_off[interior],
                               atol=1e-6)


def test_build_model_edge_tables():
    from simple_mmd_renderer.formats import pmx as P
    from fixtures import two_bone_arm
    pm = two_bone_arm()
    pm.materials[0].draw_flags |= P.MAT_DRAW_EDGE
    pm.materials[0].edge_size = 2.0
    pm.materials[0].edge_color = np.array([0, 0, 0, 1], np.float32)
    static = M.build_model(pm)
    assert len(static.edge_tris) == len(pm.triangles)
    assert (static.edge_tri_part == 0).all()
    assert static.edge_mag.max() == 2.0  # edge_scale 1 x size 2
    # flag off -> empty tables
    pm2 = two_bone_arm()
    static2 = M.build_model(pm2)
    assert len(static2.edge_tris) == 0


def test_mmd_extended_shading_toon_and_sphere():
    """Toon ramp multiplies albedo by the N-dot-L ramp; SPA sphere maps add
    after shading (beyond-parity; reference shader ignores both)."""
    static = _sphere_model(n=10)
    base_cfg = dict(width=96, height=72, shadow_map_size=64,
                    show_skybox=False, show_ground=False)
    args = (static, jnp.asarray(static.positions),
            jnp.asarray(static.normals))
    base = np.asarray(render_frame(*args, RenderConfig(**base_cfg)))
    char = np.abs(base - np.asarray(RenderConfig().clear_color)).sum(-1) \
        > 0.05

    # toon: shadow side tinted pure red
    k = 32
    ramp = np.ones((1, k, 3), np.float32)
    ramp[0, k // 2:] = [1.0, 0.0, 0.0]
    sph = [np.ones((1, 1, 3), np.float32)]
    modes = np.zeros(1, np.int32)
    toon = np.asarray(render_frame(
        *args, RenderConfig(**base_cfg), mmd_maps=(sph, modes, ramp)))
    redder = (toon[..., 0] - toon[..., 1] > 0.2) & char
    assert redder.sum() > 30, "toon shadow tint missing"
    # lit side unchanged-ish (ramp = 1 there)
    lit_same = np.abs(toon - base).sum(-1) < 0.02
    assert (lit_same & char).sum() > 30

    # SPA: additive green sphere map brightens the character (dark ramp in
    # both runs keeps the white character below the 1.0 clip)
    ramp_dark = np.full((1, k, 3), 0.3, np.float32)
    sph_w = [np.ones((1, 1, 3), np.float32)]
    base_d = np.asarray(render_frame(
        *args, RenderConfig(**base_cfg),
        mmd_maps=(sph_w, np.zeros(1, np.int32), ramp_dark)))
    sph_g = [np.full((2, 2, 3), [0.0, 0.4, 0.0], np.float32)]
    spa = np.asarray(render_frame(
        *args, RenderConfig(**base_cfg),
        mmd_maps=(sph_g, np.full(1, 2, np.int32), ramp_dark)))
    dg = (spa[..., 1] - base_d[..., 1])[char]
    assert (dg > 0.2).mean() > 0.8, "SPA additive sphere map missing"

    # SPH: multiplicative dark sphere map darkens
    sph_m = [np.full((2, 2, 3), 0.25, np.float32)]
    ramp1 = np.ones((1, k, 3), np.float32)
    sphm = np.asarray(render_frame(
        *args, RenderConfig(**base_cfg),
        mmd_maps=(sph_m, np.full(1, 1, np.int32), ramp1)))
    assert sphm[char].mean() < base[char].mean() - 0.1


def test_load_toon_ramps_and_sphere_maps_defaults():
    from simple_mmd_renderer.formats.textures import (
        default_toon_ramp, load_sphere_maps, load_toon_ramps)
    static = _sphere_model(n=6)
    # material references global toon 0 -> procedural default ramp
    static.materials[0].toon = 0
    static.materials[0].toon_is_global = True
    ramps = load_toon_ramps(static)
    assert ramps.shape == (1, 32, 3)
    np.testing.assert_allclose(ramps[0], default_toon_ramp(), atol=0)
    assert ramps[0, 0].min() > 0.95      # lit end ~white
    assert ramps[0, -1].mean() < 0.9     # shadow end tinted
    texs, modes = load_sphere_maps(static)
    assert modes.tolist() == [0]


def test_double_sided_materials():
    """double_sided=True renders MAT_DOUBLE_FACE parts from both sides with
    viewer-facing normals; default keeps the reference's back-cull."""
    static = _sphere_model(n=4)
    # replace geometry with ONE open quad facing AWAY from the camera (a
    # skirt-like open surface): back-culled by default, visible only when
    # the double-face flag is honored
    static.positions = np.array([[-4, 6, 0], [4, 6, 0],
                                 [4, 14, 0], [-4, 14, 0]], np.float32)
    static.normals = np.tile(np.array([[0, 0, 1.0]], np.float32), (4, 1))
    # winding chosen so the upload flip makes it back-facing to the camera
    static.triangles = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    static.skin_weight_dense = None
    static.nocull_tris = np.ones(2, bool)
    static.part_base = np.array([0], np.int32)
    static.part_count = np.array([2], np.int32)
    cfg = dict(width=96, height=72, shadow_map_size=64, show_skybox=False,
               show_ground=False)
    args = (static, jnp.asarray(static.positions),
            jnp.asarray(static.normals))
    clear = np.asarray(RenderConfig().clear_color)
    off = np.asarray(render_frame(*args, RenderConfig(**cfg)))
    on = np.asarray(render_frame(
        *args, RenderConfig(double_sided=True, **cfg)))
    vis_off = (np.abs(off - clear).sum(-1) > 0.05).mean()
    vis_on = (np.abs(on - clear).sum(-1) > 0.05).mean()
    # exactly one orientation of the quad is visible without double_sided
    if vis_off < 0.01:
        assert vis_on > 0.03, "double-sided quad should become visible"
    else:
        # winding was front-facing: flip it and require the culled case
        static.triangles = static.triangles[:, ::-1].copy()
        off2 = np.asarray(render_frame(*args, RenderConfig(**cfg)))
        on2 = np.asarray(render_frame(
            *args, RenderConfig(double_sided=True, **cfg)))
        assert (np.abs(off2 - clear).sum(-1) > 0.05).mean() < 0.01
        assert (np.abs(on2 - clear).sum(-1) > 0.05).mean() > 0.03
    # two-sided lighting: visible pixels lit, not uniformly dark
    shown = on if vis_off < 0.01 else np.asarray(render_frame(
        *args, RenderConfig(double_sided=True, **cfg)))
    char = np.abs(shown - clear).sum(-1) > 0.05
    assert shown[char].mean() > 0.4


def _ortho_light_vp():
    """A plausible ortho light VP (looking down -y at a tilt)."""
    import jax.numpy as jnp
    from simple_mmd_renderer.render import camera as cam
    ld = np.array([0.3, -1.0, 0.2], np.float32)
    ld /= np.linalg.norm(ld)
    view = cam.look_at(jnp.asarray(-50.0 * ld), jnp.zeros(3, jnp.float32),
                       jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
    return cam.orthographic(-5.0, 5.0, -5.0, 5.0, 0.1, 100.0) @ view


def _numpy_pcf(smap, z0, zc, zr):
    """Per-texel 3x3 PCF over an edge-clamped map: the fraction of taps
    whose depth lies behind the ground's reference depth at the texel."""
    s = smap.shape[-1]
    out = np.zeros(smap.shape, np.float64)
    for r in range(s):
        for c in range(s):
            zref = z0 + zc * c + zr * r
            taps = smap[..., np.clip(np.arange(r - 1, r + 2), 0, s - 1), :][
                ..., np.clip(np.arange(c - 1, c + 2), 0, s - 1)]
            out[..., r, c] = (zref < taps).sum((-2, -1)) / 9.0
    return out


@pytest.mark.parametrize("lead,s", [((), 64), ((3,), 64), ((), 40)],
                         ids=["single", "batched", "size40"])
def test_ground_lit_map_matches_numpy_pcf(lead, s):
    """shade.ground_lit_map (nine shifted compares in jnp) equals a per-texel
    NumPy 3x3 PCF against the ground plane's reference depth, for a single
    map, a batch [B,S,S] and a size no tile divides. Map depths sit 0.01..0.1
    off the plane, so no comparison is within rounding of a tie."""
    import jax.numpy as jnp
    from simple_mmd_renderer.render.shade import (_ground_zref_plane,
                                                  ground_lit_map)
    vp = _ortho_light_vp()
    z0, zc, zr = (float(v) for v in _ground_zref_plane(s, vp, 0.001))
    assert max(abs(zc), abs(zr)) < 1e-3 * 64 / s
    rng = np.random.default_rng(s + len(lead))
    rows, cols = np.mgrid[0:s, 0:s]
    off = rng.uniform(0.01, 0.1, lead + (s, s)) * rng.choice([-1, 1],
                                                             lead + (s, s))
    smap = (z0 + zc * cols + zr * rows + off).astype(np.float32)
    got = np.asarray(ground_lit_map(jnp.asarray(smap), vp))
    assert got.shape == lead + (s, s)
    np.testing.assert_allclose(got, _numpy_pcf(smap, z0, zc, zr), atol=1e-6)
    assert 0.0 < got.mean() < 1.0


def test_upsample_bilinear_int_matches_resize():
    """pipeline.upsample_bilinear_int (static per-phase plane blends) must
    match jax.image.resize(..., 'linear') for integer factors — it replaces
    the general gather formulation on the shadow-lit upsample."""
    import jax
    import jax.numpy as jnp
    from simple_mmd_renderer.render.pipeline import upsample_bilinear_int

    rng = np.random.default_rng(3)
    for f, (h, w) in ((2, (5, 7)), (4, (27, 48)), (3, (9, 16))):
        img = jnp.asarray(rng.random((h, w, 1), np.float32))
        got = np.asarray(upsample_bilinear_int(img, f))
        want = np.asarray(jax.image.resize(img, (h * f, w * f, 1),
                                           "linear"))
        np.testing.assert_allclose(got, want, atol=1e-6), (f, h, w)


def test_pcf_kernel_batched_and_vmapped():
    """The lit map batches over leading dims: the crowd paths (a batched
    call in the fused path; the vmapped render_frame fallback) agree
    exactly with per-map calls."""
    import jax
    import jax.numpy as jnp
    from simple_mmd_renderer.render.shade import ground_lit_map

    rng = np.random.default_rng(11)
    vp = _ortho_light_vp()
    maps = jnp.asarray(rng.random((3, 256, 256), np.float32))
    per = np.stack([np.asarray(ground_lit_map(maps[i], vp))
                    for i in range(3)])
    np.testing.assert_array_equal(np.asarray(ground_lit_map(maps, vp)), per)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda m: ground_lit_map(m, vp))(maps)), per)
