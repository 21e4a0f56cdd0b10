"""Where does the 1080p first-compile time go?

Compiles each pipeline piece separately (cache disabled) and prints wall
times: raster kernel alone, render_frame, step_pose, step_and_render, and
the 60-frame rollout. Run on the GPU; nothing else may share the card.

Usage: python scripts/profile_compile.py [piece ...]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    # NO compilation cache: measure true compile times

    from simple_mmd_renderer.app.sample import (sample_character,
                                                    sample_motion)
    from simple_mmd_renderer.config import AppConfig, RenderConfig
    from simple_mmd_renderer.core import anim as anim_mod
    from simple_mmd_renderer.core import model as model_mod
    from simple_mmd_renderer.core import physics as phys_mod
    from simple_mmd_renderer.core.scene import Scene
    from simple_mmd_renderer.render import pipeline as pl_mod
    from simple_mmd_renderer.render import raster
    from simple_mmd_renderer.ops import tiled_raster as tr

    from simple_mmd_renderer.utils.device import describe
    print(describe(), flush=True)
    width, height, shadow, density = 1920, 1080, 2048, 2.0

    pm = sample_character(density=density)
    static = model_mod.build_model(pm)
    mo = anim_mod.bind_motion(static, sample_motion(240, fps_keys=5))
    ps = phys_mod.build_physics(static)
    cfg = AppConfig()
    cfg.render = RenderConfig(width=width, height=height,
                              shadow_map_size=shadow, show_skybox=False)
    scene = Scene(static, ps, mo, cfg)
    state0 = scene.init_state()

    verts = jnp.asarray(static.positions) * 0.1
    tris = jnp.asarray(static.triangles)[:, ::-1]
    mats = pl_mod.build_matrices(cfg.render, aspect=width / height)
    normals = jnp.asarray(static.normals)

    def timed_compile(name, fn, *args):
        t0 = time.time()
        jitted = jax.jit(fn)
        lowered = jitted.lower(*args)
        t1 = time.time()
        compiled = lowered.compile()
        t2 = time.time()
        print(f"{name:24s} trace+lower {t1 - t0:7.1f}s   compile "
              f"{t2 - t1:7.1f}s", flush=True)
        return compiled

    pieces = {}

    def piece(name):
        def deco(f):
            pieces[name] = f
            return f
        return deco

    @piece("raster_attrs")
    def _():
        def f(v):
            clip = raster.transform_clip(v, mats["mvp"])
            vis, a = tr.rasterize_attrs_tiled(
                clip, tris, normals, width, height, raster.CULL_BACK,
                pl_mod._tiled_e_max(width, height))
            return vis.depth, a
        timed_compile("raster_attrs", f, verts)

    @piece("shadow")
    def _():
        def f(v):
            return pl_mod.shadow_pass(v, tris, mats["light_mvp"], shadow,
                                      tr.rasterize_tiled)
        timed_compile("shadow", f, verts)

    @piece("render_frame")
    def _():
        def f(p, n):
            return pl_mod.render_frame(static, p, n, cfg.render)
        timed_compile("render_frame", f, jnp.asarray(static.positions),
                      normals)

    @piece("step_pose")
    def _():
        timed_compile("step_pose", scene.step_pose, state0)

    @piece("step_and_render")
    def _():
        timed_compile("step_and_render", scene.step_and_render, state0)

    @piece("rollout60")
    def _():
        def f(s):
            return scene.rollout(s, 60, render=True)
        timed_compile("rollout60", f, state0)

    sel = sys.argv[1:] or list(pieces)
    print(f"# backend={jax.default_backend()} {width}x{height} "
          f"shadow={shadow} tris={len(static.triangles)}", flush=True)
    for name in sel:
        pieces[name]()


if __name__ == "__main__":
    main()
