"""Solver-iteration fidelity curve (r2 VERDICT weak #6).

The XPBD solver's iteration count is a perf knob (8 -> 6 bought +2.6 fps in
round 2); this script pins what that knob trades: the RMS / max deviation of
every dynamic rigid body (hair strands, skirt hem) against a 32-iteration
reference solve over the 4 s bench motion. The physics rig is identical to
the bench scene's (bodies derive from the bone rig; mesh density does not
affect them), so the curve transfers to bench.py's configuration directly.

Run on CPU or GPU (results are hardware-independent to f32 rounding):
    python scripts/solver_fidelity.py
"""

import sys

import numpy as np


def build(iters):
    import jax
    import jax.numpy as jnp

    from simple_mmd_renderer.app.sample import (sample_character,
                                                    sample_motion)
    from simple_mmd_renderer.config import AppConfig
    from simple_mmd_renderer.core import anim as anim_mod
    from simple_mmd_renderer.core import model as model_mod
    from simple_mmd_renderer.core import physics as phys_mod
    from simple_mmd_renderer.core.scene import Scene

    pm = sample_character(density=0.3)   # bodies/joints identical at any density
    static = model_mod.build_model(pm)
    mo = anim_mod.bind_motion(static, sample_motion(240, fps_keys=5))
    ps = phys_mod.build_physics(static)
    cfg = AppConfig()
    cfg.physics.solver_iterations = iters
    return Scene(static, ps, mo, cfg), ps


def trajectory(iters, frames=120):
    import jax
    import jax.numpy as jnp

    scene, ps = build(iters)

    def body(state, _):
        state, pose, pos, nrm = scene.step_pose(state)
        return state, state.physics.pos

    roll = jax.jit(lambda s: jax.lax.scan(body, s, None, length=frames))
    _, traj = roll(scene.init_state())
    dyn = np.asarray(ps.inv_mass) > 0
    return np.asarray(traj)[:, dyn, :]          # [N, R_dyn, 3] MMD units


def main():
    frames = 120                                  # 4 s at 30 fps
    ref = trajectory(32, frames)
    print(f"# {ref.shape[1]} dynamic bodies, {frames} frames (4 s), "
          "deviation vs 32-iteration solve (MMD units; character ~20 tall)",
          file=sys.stderr)
    print(f"{'iters':>6} {'rms':>9} {'p95':>9} {'max':>9}")
    for it in (2, 4, 6, 8, 16, 32):
        traj = trajectory(it, frames)
        d = np.linalg.norm(traj - ref, axis=-1)   # [N, R_dyn]
        print(f"{it:>6} {np.sqrt((d ** 2).mean()):>9.4f} "
              f"{np.percentile(d, 95):>9.4f} {d.max():>9.4f}")


if __name__ == "__main__":
    main()
