"""Per-stage GPU timings for the bench scene (1080p flagship character).

Each stage is measured as a lax.scan over N iterations with a scalar carry
threaded through the inputs (prevents XLA from hoisting loop-invariant work
out of the scan) and a checksum carried out (prevents DCE). One dispatch per
stage, one tiny host transfer — per-dispatch latency never enters the
numbers.

Usage: python scripts/profile_stages.py [stage ...]   (default: all)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from simple_mmd_renderer.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from simple_mmd_renderer.app.sample import (sample_character,
                                                    sample_motion)
    from simple_mmd_renderer.config import AppConfig, RenderConfig
    from simple_mmd_renderer.core import anim as anim_mod
    from simple_mmd_renderer.core import model as model_mod
    from simple_mmd_renderer.core import physics as phys_mod
    from simple_mmd_renderer.core import pose as pose_mod
    from simple_mmd_renderer.core.scene import Scene
    from simple_mmd_renderer.render import raster
    from simple_mmd_renderer.render import pipeline as pl_mod
    from simple_mmd_renderer.ops import tiled_raster as tr

    from simple_mmd_renderer.utils.device import describe
    print(describe(), flush=True)
    width, height, shadow, density, iters = 1920, 1080, 2048, 2.0, 30
    # PROFILE_DENSITY=4.0 profiles the large-mesh stress scene instead
    density = float(os.environ.get("PROFILE_DENSITY", density))

    pm = sample_character(density=density)
    static = model_mod.build_model(pm)
    mo = anim_mod.bind_motion(static, sample_motion(240, fps_keys=5))
    ps = phys_mod.build_physics(static)
    cfg = AppConfig()
    cfg.render = RenderConfig(width=width, height=height,
                              shadow_map_size=shadow, show_skybox=False)
    scene = Scene(static, ps, mo, cfg)
    state0 = scene.init_state()

    # a fixed deformed frame to feed render-only stages
    _, pose, positions, normals = jax.jit(scene.step_pose)(state0)
    positions = jax.block_until_ready(positions)
    verts_m = positions * cfg.render.mmd_to_meter
    tris = jnp.asarray(static.triangles)[:, ::-1]
    mats = pl_mod.build_matrices(cfg.render, aspect=width / height)
    attrs = jnp.concatenate(
        [verts_m, jnp.asarray(normals), jnp.asarray(static.uvs)], -1)

    e_max = pl_mod._tiled_e_max(width, height)

    def timed(name, body, n=iters):
        """body(carry_scalar) -> checksum scalar."""
        def scan_body(c, _):
            return body(c), None

        fn = jax.jit(lambda c: jax.lax.scan(scan_body, c, None, length=n)[0])
        c = fn(jnp.float32(0.0))
        c.block_until_ready()
        t0 = time.time()
        c = fn(c * 1e-20)
        c.block_until_ready()
        dt = (time.time() - t0) / n * 1000
        print(f"{name:24s} {dt:8.3f} ms   (checksum {float(c):.4g})",
              flush=True)
        return dt

    stages = {}

    def stage(name):
        def deco(f):
            stages[name] = f
            return f
        return deco

    @stage("full_frame")
    def _(c):
        st = state0.replace(time=state0.time + c * 1e-20)
        st, img = scene.step_and_render(st)
        return jnp.mean(img)

    @stage("pose_only")
    def _(c):
        st = state0.replace(time=state0.time + c * 1e-20)
        st, pose_, p, n = scene.step_pose(st)
        return jnp.mean(p)

    @stage("anim_sample")
    def _(c):
        frame = jnp.floor((state0.time + c * 1e-20) * cfg.fps)
        r, t, m = anim_mod.sample_motion(mo, frame)
        return jnp.mean(r) + jnp.mean(t)

    @stage("pre_physics_pose")
    def _(c):
        b = static.n_bones
        rot = jnp.broadcast_to(jnp.asarray([0, 0, 0, 1.0], jnp.float32),
                               (b, 4)) + c * 1e-20
        trans = jnp.zeros((b, 3), jnp.float32)
        rates = jnp.zeros((static.n_morphs,), jnp.float32)
        pose_ = pose_mod.pre_physics_posing(static, rot, trans, rates)
        return jnp.mean(pose_.skin)

    @stage("physics_react")
    def _(c):
        st = state0.physics.replace(pos=state0.physics.pos + c * 1e-20)
        st2, pose2 = phys_mod.physics_react(static, ps, st, pose, cfg.physics)
        return jnp.mean(st2.pos)

    @stage("deform")
    def _(c):
        pose2 = pose.replace(skin=pose.skin + c * 1e-20)
        p, n = pose_mod.deform(static, pose2)
        return jnp.mean(p)

    @stage("char_setup_rows")
    def _(c):
        clip = raster.transform_clip(verts_m + c * 1e-20, mats["mvp"])
        s = raster.setup(clip, tris, width, height, raster.CULL_BACK)
        s["va"] = attrs[tris]
        rows = tr._setup_rows(s, jnp.arange(tris.shape[0], dtype=jnp.int32),
                              attrs)
        return jnp.mean(rows)

    @stage("char_bin")
    def _(c):
        clip = raster.transform_clip(verts_m + c * 1e-20, mats["mvp"])
        s = raster.setup(clip, tris, width, height, raster.CULL_BACK)
        s["va"] = attrs[tris]
        rows = tr._setup_rows(s, jnp.arange(tris.shape[0], dtype=jnp.int32),
                              attrs)
        sorted_rows, starts, counts, big = tr._bin(s, rows, width, height,
                                                   e_max)
        return (jnp.mean(sorted_rows) + jnp.mean(starts.astype(jnp.float32))
                + jnp.mean(counts.astype(jnp.float32)))

    @stage("char_raster_full")
    def _(c):
        clip = raster.transform_clip(verts_m + c * 1e-20, mats["mvp"])
        vis, attr_px = tr.rasterize_attrs_tiled(
            clip, tris, attrs, width, height, raster.CULL_BACK, e_max)
        return jnp.mean(attr_px) + jnp.mean(vis.depth)

    # PRODUCTION character raster: deferred-UV (3 normal channels only),
    # production e_max and the compacted-prefix binning — what render_frame
    # actually launches at this scene
    @stage("char_raster_prod")
    def _(c):
        clip = raster.transform_clip(verts_m + c * 1e-20, mats["mvp"])
        vis, attr_px = tr.rasterize_attrs_tiled(
            clip, tris, jnp.asarray(normals), width, height,
            raster.CULL_BACK, e_max, None, True)
        return jnp.mean(attr_px) + jnp.mean(vis.depth)

    @stage("shadow_pass")
    def _(c):
        sm = pl_mod.shadow_pass(verts_m + c * 1e-20, tris, mats["light_mvp"],
                                cfg.render.shadow_map_size,
                                tr.rasterize_tiled)
        return jnp.mean(sm)

    @stage("render_frame_only")
    def _(c):
        img = pl_mod.render_frame(static, positions + c * 1e-20, normals,
                                  cfg.render)
        return jnp.mean(img)

    @stage("ground_pass")
    def _(c):
        mask, hit, depth = pl_mod.ground_pass(
            cfg.render, mats["view"] + c * 1e-20, mats["proj"], width, height)
        return jnp.mean(depth)

    # shadow-space PCF lit map + the downsampled screen lookup (the
    # ground's shadow-receive cost in render_frame)
    from simple_mmd_renderer.render import shade as shade_mod
    sm_fixed = jax.block_until_ready(
        pl_mod.shadow_pass(verts_m, tris, mats["light_mvp"],
                           cfg.render.shadow_map_size,
                           tr.rasterize_tiled))

    @stage("ground_lit")
    def _(c):
        lit_map = shade_mod.ground_lit_map(sm_fixed + c * 1e-20,
                                           mats["light_vp"])
        ds = max(int(cfg.render.shadow_lookup_downsample), 1)
        lw, lh = width // ds, height // ds
        _, gpos_lo, _ = pl_mod.ground_pass(cfg.render, mats["view"],
                                           mats["proj"], lw, lh)
        lclip = raster.transform_clip(
            gpos_lo.reshape(-1, 3), mats["light_vp"]).reshape(lh, lw, 4)
        lit_lo = shade_mod.ground_shadow_lookup(lclip, lit_map,
                                                jnp.asarray(True))
        lit = jax.image.resize(lit_lo, (height, width, 1), "linear")
        return jnp.mean(lit)

    @stage("ground_lit_map_only")
    def _(c):
        lit_map = shade_mod.ground_lit_map(sm_fixed + c * 1e-20,
                                           mats["light_vp"])
        return jnp.mean(lit_map)

    @stage("ground_lookup_resize")
    def _(c):
        lit_map = sm_fixed + c * 1e-20   # stand-in map, same shape
        ds = max(int(cfg.render.shadow_lookup_downsample), 1)
        lw, lh = width // ds, height // ds
        _, gpos_lo, _ = pl_mod.ground_pass(cfg.render, mats["view"],
                                           mats["proj"], lw, lh)
        lclip = raster.transform_clip(
            gpos_lo.reshape(-1, 3), mats["light_vp"]).reshape(lh, lw, 4)
        lit_lo = shade_mod.ground_shadow_lookup(lclip, lit_map,
                                                jnp.asarray(True))
        lit = jax.image.resize(lit_lo, (height, width, 1), "linear")
        return jnp.mean(lit)

    @stage("shade_char")
    def _(c):
        nrm_px = jnp.ones((height, width, 3), jnp.float32) * 0.577 + c * 1e-20
        wp = jnp.zeros((height, width, 3), jnp.float32)
        col = shade_mod.shade_character(
            jnp.ones((height, width, 3), jnp.float32), nrm_px, wp,
            jnp.asarray(cfg.render.camera_pos, jnp.float32), cfg.render)
        return jnp.mean(col)

    @stage("unproject")
    def _(c):
        d = jnp.full((height, width), 0.5, jnp.float32) + c * 1e-20
        wp = pl_mod.unproject_depth(d, mats["proj"] @ mats["view"],
                                    width, height)
        return jnp.mean(wp)

    sel = sys.argv[1:] or list(stages)
    print(f"# backend={jax.default_backend()} {width}x{height} "
          f"shadow={shadow} verts={len(static.positions)} "
          f"tris={len(static.triangles)} iters={iters}", flush=True)
    for name in sel:
        timed(name, stages[name])


if __name__ == "__main__":
    main()
