"""Stress benchmarks beyond bench.py's flagship point, on the GPU:

- large-mesh: high-density sample character (~56k verts / ~107k tris) at
  1080p — where binning cost grows fastest.
- crowd: 64 instances with physics at 256x144 — BASELINE config 5.

Prints one line per measurement.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
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

    from simple_mmd_renderer.utils.device import describe
    print(describe(), flush=True)
    which = sys.argv[1:] or ["large", "crowd", "crowd-dense", "crowd-tex"]

    def scene_at(density, width, height, shadow=2048, frames=120,
                 textures=None):
        pm = sample_character(density=density)
        static = model_mod.build_model(pm)
        mo = anim_mod.bind_motion(static, sample_motion(frames, fps_keys=5))
        ps = phys_mod.build_physics(static)
        cfg = AppConfig()
        cfg.render = RenderConfig(width=width, height=height,
                                  shadow_map_size=shadow, show_skybox=False)
        return Scene(static, ps, mo, cfg, part_textures=textures)

    if "large" in which:
        scene = scene_at(4.0, 1920, 1080, 2048)
        n = 30
        print(f"# large mesh: {len(scene.static.positions)} verts, "
              f"{len(scene.static.triangles)} tris", flush=True)
        roll = scene.jit_rollout(n, render=True)
        state, cs = roll(scene.init_state())
        np.asarray(cs)
        t0 = time.time()
        state, cs = roll(state)
        np.asarray(cs)
        fps = n / (time.time() - t0)
        print(f"large-mesh 1080p: {fps:.1f} fps", flush=True)

    def run_crowd(label, scene, n_inst, frames):
        crowd = par.crowd_init(scene, n_inst)

        def rollout(state):
            import jax.numpy as jnp

            def body(s, _):
                s, img = par.crowd_step_fn(scene, render=True)(s)
                return s, jnp.mean(img)
            return jax.lax.scan(body, state, None, length=frames)

        roll = jax.jit(rollout, donate_argnums=(0,))
        state, cs = roll(crowd)
        np.asarray(cs)
        t0 = time.time()
        state, cs = roll(state)
        np.asarray(cs)
        dt = time.time() - t0
        w, h = scene.config.render.width, scene.config.render.height
        print(f"{label} {n_inst}x{w}x{h}: "
              f"{n_inst * frames / dt:.0f} instance-frames/s "
              f"({frames / dt:.1f} crowd-steps/s)", flush=True)

    n_inst, w, h, frames, shadow = 64, 256, 144, 30, 256

    if "crowd" in which:
        run_crowd("crowd", scene_at(0.5, w, h, shadow), n_inst, frames)

    if "crowd-dense" in which:
        # 64 instances at the BENCH density (25.6k tris each -> 1.6M fused
        # sort entries): past a 2^18 packed key; exercises the dynamic key
        # budget
        run_crowd("crowd-dense", scene_at(2.0, w, h, shadow), n_inst, frames)

    if "crowd-tex" in which:
        # fused crowd with per-part textures AND native 4x MSAA
        from simple_mmd_renderer.app.sample import sample_textures
        scene = scene_at(0.5, w, h, shadow,
                         textures=sample_textures((256, 128)))
        scene.config.render.msaa = 4
        from simple_mmd_renderer.render.pipeline import (
            crowd_render_supported)
        assert crowd_render_supported(scene.config.render,
                                      scene.part_textures)
        run_crowd("crowd-tex-msaa", scene, n_inst, frames)


if __name__ == "__main__":
    main()
