"""Split bench.py's huge 'compile+first rollout' time into its parts:

AOT lower, AOT compile, first execution, second execution — optionally with
the persistent compilation cache enabled (bench enables it).

Usage: python scripts/profile_first_run.py [cache]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import numpy as np

    if "cache" in sys.argv[1:]:
        from simple_mmd_renderer.utils.cache import enable_compilation_cache
        enable_compilation_cache()
        print("# persistent compilation cache ENABLED", flush=True)

    from simple_mmd_renderer.app.sample import (sample_character,
                                                    sample_motion)
    from simple_mmd_renderer.config import AppConfig, RenderConfig
    from simple_mmd_renderer.core import anim as anim_mod
    from simple_mmd_renderer.core import model as model_mod
    from simple_mmd_renderer.core import physics as phys_mod
    from simple_mmd_renderer.core.scene import Scene

    from simple_mmd_renderer.utils.device import describe
    print(describe(), flush=True)
    width, height, shadow, density, frames = 1920, 1080, 2048, 2.0, 60

    pm = sample_character(density=density)
    static = model_mod.build_model(pm)
    mo = anim_mod.bind_motion(static, sample_motion(240, fps_keys=5))
    ps = phys_mod.build_physics(static)
    cfg = AppConfig()
    cfg.render = RenderConfig(width=width, height=height,
                              shadow_map_size=shadow, show_skybox=False)
    scene = Scene(static, ps, mo, cfg)

    t0 = time.time()
    state = scene.init_state()
    jax.block_until_ready(state)
    print(f"init_state          {time.time() - t0:7.1f}s", flush=True)

    import functools
    roll = jax.jit(functools.partial(scene.rollout, n_frames=frames,
                                     render=True))
    t0 = time.time()
    lowered = roll.lower(state)
    print(f"lower               {time.time() - t0:7.1f}s", flush=True)
    t0 = time.time()
    compiled = lowered.compile()
    print(f"compile             {time.time() - t0:7.1f}s", flush=True)

    t0 = time.time()
    st, cs = compiled(state)
    np.asarray(cs)
    print(f"first execution     {time.time() - t0:7.1f}s", flush=True)

    t0 = time.time()
    st, cs = compiled(st)
    np.asarray(cs)
    dt = time.time() - t0
    print(f"second execution    {dt:7.1f}s  ({frames / dt:.1f} fps)",
          flush=True)


if __name__ == "__main__":
    main()
