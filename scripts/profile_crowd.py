"""Per-stage timings for the 64-instance crowd (BASELINE config 5).

Isolates where a crowd step's time goes: animation+pose+physics (vmapped),
deform, character raster, shadow raster, shading — each as one scanned
dispatch like scripts/profile_stages.py.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from simple_mmd_renderer.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from simple_mmd_renderer.app.sample import (sample_character,
                                                    sample_motion)
    from simple_mmd_renderer.config import AppConfig, RenderConfig
    from simple_mmd_renderer.core import anim as anim_mod
    from simple_mmd_renderer.core import model as model_mod
    from simple_mmd_renderer.core import physics as phys_mod
    from simple_mmd_renderer.core.scene import Scene
    from simple_mmd_renderer.parallel import mesh as par
    from simple_mmd_renderer.render import pipeline as pl_mod

    from simple_mmd_renderer.utils.device import describe
    print(describe(), flush=True)
    n_inst, w, h, shadow, iters = 64, 256, 144, 256, 10

    pm = sample_character(density=0.5)
    static = model_mod.build_model(pm)
    mo = anim_mod.bind_motion(static, sample_motion(120, fps_keys=5))
    ps = phys_mod.build_physics(static)
    cfg = AppConfig()
    cfg.render = RenderConfig(width=w, height=h, shadow_map_size=shadow,
                              show_skybox=False)
    scene = Scene(static, ps, mo, cfg)
    crowd0 = par.crowd_init(scene, n_inst)

    # fixed deformed batch for render-only stages
    _, _, positions, normals = jax.jit(jax.vmap(scene.step_pose))(crowd0)
    positions = jax.block_until_ready(positions)

    def timed(name, body):
        def scan_body(c, _):
            return body(c), None
        fn = jax.jit(lambda c: jax.lax.scan(scan_body, c, None, length=iters)[0])
        c = fn(jnp.float32(0.0))
        c.block_until_ready()
        t0 = time.time()
        c = fn(c * 1e-20)
        c.block_until_ready()
        dt = (time.time() - t0) / iters * 1000
        print(f"{name:26s} {dt:9.3f} ms/crowd-step "
              f"({dt / n_inst:7.3f} ms/inst)", flush=True)

    def crowd_full(c):
        st = crowd0.replace(time=crowd0.time + c * 1e-20)
        st, img = jax.vmap(scene.step_and_render)(st)
        return jnp.mean(img)

    def crowd_pose(c):
        st = crowd0.replace(time=crowd0.time + c * 1e-20)
        st, pose, p, n = jax.vmap(scene.step_pose)(st)
        return jnp.mean(p)

    def crowd_render(c):
        return jnp.mean(jax.vmap(
            lambda p, n: pl_mod.render_frame(static, p, n, cfg.render))(
                positions + c * 1e-20, normals))

    def crowd_char_raster(c):
        from simple_mmd_renderer.ops.tiled_raster import (
            rasterize_attrs_tiled)
        from simple_mmd_renderer.render import raster
        mats = pl_mod.build_matrices(cfg.render, aspect=w / h)
        tris = jnp.asarray(static.triangles)[:, ::-1]
        attrs = jnp.asarray(normals)

        def one(p, a):
            clip = raster.transform_clip(p * 0.1, mats["mvp"])
            vis, ap = rasterize_attrs_tiled(clip, tris, a, w, h,
                                            raster.CULL_BACK,
                                            pl_mod._tiled_e_max(w, h))
            return jnp.mean(ap) + jnp.mean(vis.depth)
        return jnp.mean(jax.vmap(one)(positions + c * 1e-20, normals))

    def crowd_shadow(c):
        mats = pl_mod.build_matrices(cfg.render, aspect=w / h)
        tris = jnp.asarray(static.triangles)[:, ::-1]
        from simple_mmd_renderer.ops.tiled_raster import rasterize_tiled

        def one(p):
            return jnp.mean(pl_mod.shadow_pass(
                p * 0.1, tris, mats["light_mvp"], shadow, rasterize_tiled))
        return jnp.mean(jax.vmap(one)(positions + c * 1e-20))

    print(f"# backend={jax.default_backend()} {n_inst} inst @ {w}x{h} "
          f"shadow={shadow} verts={len(static.positions)} "
          f"tris={len(static.triangles)}", flush=True)
    for name, fn in [("crowd_full", crowd_full),
                     ("crowd_pose+physics", crowd_pose),
                     ("crowd_render", crowd_render),
                     ("crowd_char_raster", crowd_char_raster),
                     ("crowd_shadow", crowd_shadow)]:
        timed(name, fn)


if __name__ == "__main__":
    main()
