"""Measure the valid-triangle fraction per raster pass on the bench scenes.

The prefix-compaction ladder (ops.tiled_raster.COMPACT_RUNGS) bins only the
smallest static prefix >= the frame's valid-triangle count; its waste is the
gap between n_valid/T and the chosen rung. This probe reports n_valid/T for
the main (CULL_BACK) and shadow (CULL_FRONT) passes across animated frames,
to decide whether an extra rung would pay for its fleet compile cost.
"""

import os
import sys

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
    from simple_mmd_renderer.render import pipeline as pl
    from simple_mmd_renderer.render import raster

    for density, label in [(2.0, "flagship"), (4.0, "stress")]:
        pm = sample_character(density=density)
        static = model_mod.build_model(pm)
        mo = anim_mod.bind_motion(static, sample_motion(240, fps_keys=5))
        ps = phys_mod.build_physics(static)
        cfg = AppConfig()
        cfg.render = RenderConfig(width=1920, height=1080,
                                  shadow_map_size=2048, show_skybox=False)
        scene = Scene(static, ps, mo, cfg)
        rcfg = cfg.render
        mats = pl.build_matrices(rcfg, None, aspect=1920 / 1080)
        tris = jnp.asarray(static.triangles)[:, ::-1]

        def frame_fracs(state):
            state, _pose, positions, _normals = scene.step_pose(state)
            verts_m = positions * rcfg.mmd_to_meter
            clip = jax.vmap(
                lambda v: raster.transform_clip(v, mats["mvp"]))(verts_m)
            sm = raster.setup(clip, tris, 1920, 1080, raster.CULL_BACK)
            sclip = jax.vmap(
                lambda v: raster.transform_clip(v, mats["light_mvp"]))(verts_m)
            ss = raster.setup(sclip, tris, rcfg.shadow_map_size,
                              rcfg.shadow_map_size, raster.CULL_FRONT)
            return state, (jnp.mean(sm["valid"].astype(jnp.float32)),
                           jnp.mean(ss["valid"].astype(jnp.float32)))

        roll = jax.jit(lambda st: jax.lax.scan(
            lambda s, _: frame_fracs(s), st, None, length=30))
        _, (fm, fs) = roll(scene.init_state())
        fm, fs = np.asarray(fm), np.asarray(fs)
        print(f"{label}: T={tris.shape[0]}  main valid "
              f"{fm.mean():.3f} (min {fm.min():.3f} max {fm.max():.3f})  "
              f"shadow valid {fs.mean():.3f} "
              f"(min {fs.min():.3f} max {fs.max():.3f})")


if __name__ == "__main__":
    main()
