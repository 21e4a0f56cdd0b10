"""Flagship-only throughput measurement on the GPU (the bench.py headline
row), for quick A/B of raster/bin experiments, e.g.:

    python scripts/bench_flagship.py                # current default
    python scripts/bench_flagship.py 3/8,1/2,5/8    # another compaction ladder
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
    from simple_mmd_renderer.ops import tiled_raster as tr

    from simple_mmd_renderer.utils.device import describe
    print(describe(), flush=True)
    if len(sys.argv) > 1:
        tr.COMPACT_RUNGS = tuple(tuple(int(x) for x in r.split("/"))
                                 for r in sys.argv[1].split(","))
    width, height, shadow, density, frames = 1920, 1080, 2048, 2.0, 60

    pm = sample_character(density=density)
    static = model_mod.build_model(pm)
    mo = anim_mod.bind_motion(static, sample_motion(240, fps_keys=5))
    ps = phys_mod.build_physics(static)
    cfg = AppConfig()
    cfg.render = RenderConfig(width=width, height=height,
                              shadow_map_size=shadow, show_skybox=False)
    scene = Scene(static, ps, mo, cfg)

    roll = scene.jit_rollout(frames, render=True)
    t0 = time.time()
    state, cs = roll(scene.init_state())
    np.asarray(cs)
    print(f"# rungs={tr.COMPACT_RUNGS} compile+first: {time.time() - t0:.1f}s")
    best = 0.0
    for _ in range(3):
        t0 = time.time()
        state, cs = roll(state)
        cs = np.asarray(cs)
        best = max(best, frames / (time.time() - t0))
        assert np.isfinite(cs).all() and (np.abs(np.diff(cs)) > 0).any(), \
            "frames did not advance"
    print(f"flagship: {best:.1f} fps (best of 3) rungs={tr.COMPACT_RUNGS}")


if __name__ == "__main__":
    main()
