"""Measure crowd inst-fps across feature configs on the GPU: the fused
baseline (64 inst, textured + msaa=4, 256x144) against show_edges (a second
multi-instance raster over the displaced hull) and double_sided (the shared
nocull mask). Prints one line per config.

Usage: python scripts/profile_crowd_fallback.py [n_inst] [frames]
"""
import sys
import time

sys.path.insert(0, ".")


def main():
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from simple_mmd_renderer.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from simple_mmd_renderer.utils.device import describe
    print(describe(), flush=True)

    from simple_mmd_renderer.app.sample import (sample_character,
                                                    sample_motion,
                                                    sample_textures)
    from simple_mmd_renderer.config import AppConfig, RenderConfig
    from simple_mmd_renderer.core import anim as anim_mod
    from simple_mmd_renderer.core import model as model_mod
    from simple_mmd_renderer.core import physics as phys_mod
    from simple_mmd_renderer.core.scene import Scene
    from simple_mmd_renderer.parallel import mesh as par

    n_inst = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    n_cf = int(sys.argv[2]) if len(sys.argv) > 2 else 20

    pm = sample_character(density=0.5)
    static = model_mod.build_model(pm)
    mo = anim_mod.bind_motion(static, sample_motion(120, fps_keys=5))
    ps = phys_mod.build_physics(static)

    def run(label, render_kw):
        cfg = AppConfig()
        cfg.render = RenderConfig(width=256, height=144,
                                  shadow_map_size=256, show_skybox=False,
                                  msaa=4, **render_kw)
        scene = Scene(static, ps, mo, cfg,
                      part_textures=sample_textures())
        step = par.crowd_step_fn(scene)

        def roll(state):
            def body(st, _):
                st, imgs = step(st)
                return st, jnp.mean(imgs)
            return jax.lax.scan(body, state, None, length=n_cf)

        roll_j = jax.jit(roll)
        st, cs = roll_j(par.crowd_init(scene, n_inst))
        np.asarray(cs)
        t0 = time.time()
        st, cs = roll_j(st)
        np.asarray(cs)
        f = n_cf * n_inst / (time.time() - t0)
        print(f"{label:34s} {f:8.0f} inst-fps", flush=True)
        return f

    run("fused (baseline)", {})
    run("show_edges", {"show_edges": True})
    run("double_sided", {"double_sided": True})


if __name__ == "__main__":
    main()
