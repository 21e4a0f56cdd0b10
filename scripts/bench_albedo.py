"""Albedo-strategy microbench on the GPU: textured frame cost with
bbox-window gathers vs full-frame gathers vs untextured, at 1080p and 720p.

Isolates the render (fixed pose, slightly perturbed per scan iteration so
XLA cannot hoist the body out of the loop); reports ms/frame per variant.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    from simple_mmd_renderer.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from simple_mmd_renderer.app.sample import (sample_character,
                                                    sample_textures)
    from simple_mmd_renderer.config import AppConfig, RenderConfig
    from simple_mmd_renderer.core import model as model_mod
    from simple_mmd_renderer.core import pose as pose_mod
    from simple_mmd_renderer.render.pipeline import (build_packed_atlas,
                                                         render_frame)

    from simple_mmd_renderer.utils.device import describe
    print(describe(), flush=True)
    pm = sample_character(density=2.0)
    static = model_mod.build_model(pm)
    b = static.n_bones
    rot = jnp.broadcast_to(jnp.asarray([0, 0, 0, 1.0], jnp.float32), (b, 4))
    trans = jnp.zeros((b, 3), jnp.float32)
    rates = jnp.zeros((static.n_morphs,), jnp.float32)
    pose = pose_mod.pre_physics_posing(static, rot, trans, rates)
    positions, normals = pose_mod.deform(static, pose)
    textures = sample_textures()
    atlas = build_packed_atlas(textures)

    n = 30
    sizes = [(1920, 1080), (1280, 720)]

    def run(label, w, h, tex, window):
        cfg = RenderConfig(width=w, height=h, shadow_map_size=2048,
                           show_skybox=False, albedo_window=window)

        def body(c, i):
            img = render_frame(
                static, positions + 0.001 * i, normals, cfg,
                part_textures=textures if tex else None,
                atlas=atlas if tex else None)
            return c + jnp.mean(img), None

        roll = jax.jit(lambda: jax.lax.scan(
            body, jnp.float32(0.0), jnp.arange(n, dtype=jnp.float32))[0])
        float(roll())                      # compile + warm
        t0 = time.time()
        float(roll())
        ms = (time.time() - t0) / n * 1000.0
        print(f"{label:44s} {ms:7.2f} ms/frame", flush=True)
        return ms

    for w, h in sizes:
        base = run(f"untextured {w}x{h}", w, h, False, True)
        full = run(f"textured full-frame {w}x{h}", w, h, True, False)
        win = run(f"textured windowed {w}x{h}", w, h, True, True)
        print(f"  -> texture cost: full {full - base:.2f} ms, "
              f"windowed {win - base:.2f} ms", flush=True)

    # ---- component breakdown: where does the textured delta go?
    from simple_mmd_renderer.render import raster as raster_mod
    from simple_mmd_renderer.render.pipeline import (
        build_matrices, character_albedo, character_albedo_windowed)
    from simple_mmd_renderer.ops.tiled_raster import rasterize_attrs_tiled

    for w, h in sizes:
        cfg = RenderConfig(width=w, height=h, show_skybox=False)
        mats = build_matrices(cfg, None, aspect=w / h)
        verts_m = positions * cfg.mmd_to_meter
        tris = jnp.asarray(static.triangles)[:, ::-1]
        clip0 = raster_mod.transform_clip(verts_m, mats["mvp"])
        uvs = jnp.asarray(static.uvs)

        def raster_only(n_attr_uv):
            def body(c, i):
                clip = clip0.at[:, 0].add(0.0001 * i)
                attrs = (jnp.concatenate([jnp.asarray(normals), uvs], -1)
                         if n_attr_uv else jnp.asarray(normals))
                vis, attr_px = rasterize_attrs_tiled(
                    clip, tris, attrs, w, h, raster_mod.CULL_BACK, 16)
                return c + jnp.mean(attr_px) + jnp.mean(vis.depth), None
            roll = jax.jit(lambda: jax.lax.scan(
                body, jnp.float32(0.0),
                jnp.arange(n, dtype=jnp.float32))[0])
            float(roll())
            t0 = time.time()
            float(roll())
            return (time.time() - t0) / n * 1000.0

        r3 = raster_only(False)
        r5 = raster_only(True)
        print(f"raster {w}x{h}: 3 attrs {r3:.2f} ms, +uv {r5:.2f} ms "
              f"(delta {r5 - r3:.2f})", flush=True)

        # albedo pass alone over a fixed visibility buffer
        vis0, attr0 = jax.jit(partial_raster := (lambda: rasterize_attrs_tiled(
            clip0, tris, jnp.concatenate([jnp.asarray(normals), uvs], -1),
            w, h, raster_mod.CULL_BACK, 16)))()
        tri_img = jax.block_until_ready(vis0.tri)
        uv_img = jax.block_until_ready(attr0[..., 3:5])

        def albedo_only(windowed):
            fn = (character_albedo_windowed if windowed
                  else character_albedo)

            def body(c, i):
                out = fn(static, tri_img, uv_img + 0.0001 * i, textures,
                         atlas)
                return c + jnp.mean(out), None
            roll = jax.jit(lambda: jax.lax.scan(
                body, jnp.float32(0.0),
                jnp.arange(n, dtype=jnp.float32))[0])
            float(roll())
            t0 = time.time()
            float(roll())
            return (time.time() - t0) / n * 1000.0

        af = albedo_only(False)
        aw = albedo_only(True)
        print(f"albedo {w}x{h}: full {af:.2f} ms, windowed {aw:.2f} ms",
              flush=True)


if __name__ == "__main__":
    main()
