"""Benchmark on one GPU: full step+render (animation, CCD IK, physics,
skinning, shadow pass, main pass) of the flagship procedural character at
1080p, then the secondary cells.

Baseline (BASELINE.md): the reference publishes no numbers; the north-star
target is 60+ fps for a full PMX-scale model with physics at 1080p on one
accelerator. vs_baseline = fps / 60.

Measurement: N frames run inside ONE device program (lax.scan over the frame
step) with a per-frame framebuffer checksum carried out, so the number is
device throughput — a single dispatch and a single tiny host transfer.

Exits non-zero without a GPU. Prints the device and card on stderr, then one
JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
"""

import json
import sys
import time

import numpy as np


def main():
    import jax

    from simple_mmd_renderer.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from simple_mmd_renderer.app.sample import (sample_character,
                                                    sample_motion)
    from simple_mmd_renderer.config import AppConfig, RenderConfig
    from simple_mmd_renderer.core import anim as anim_mod
    from simple_mmd_renderer.core import model as model_mod
    from simple_mmd_renderer.core import physics as phys_mod
    from simple_mmd_renderer.core.scene import Scene
    from simple_mmd_renderer.utils.device import card_line, require_gpu

    device = require_gpu()
    print(f"# device: {device['platform']} {device['kind']} "
          f"x{device['count']}", file=sys.stderr)
    print(f"# card: {card_line()}", file=sys.stderr)
    width, height, shadow, density, frames = 1920, 1080, 2048, 2.0, 60

    pm = sample_character(density=density)
    static = model_mod.build_model(pm)
    mo = anim_mod.bind_motion(static, sample_motion(240, fps_keys=5))
    ps = phys_mod.build_physics(static)

    cfg = AppConfig()
    cfg.render = RenderConfig(width=width, height=height,
                              shadow_map_size=shadow, show_skybox=False)
    scene = Scene(static, ps, mo, cfg)

    print(f"# bench scene: {len(static.positions)} verts, "
          f"{len(static.triangles)} tris, {static.n_bones} bones, "
          f"{ps.n_bodies} bodies, {ps.n_joints} joints @ {width}x{height} "
          f"on {jax.default_backend()}", file=sys.stderr)

    roll = scene.jit_rollout(frames, render=True)

    t0 = time.time()
    state, checksums = roll(scene.init_state())
    _ = np.asarray(checksums)
    print(f"# compile+first rollout: {time.time() - t0:.1f}s", file=sys.stderr)

    t0 = time.time()
    state, checksums = roll(state)
    cs = np.asarray(checksums)  # forces completion of the whole rollout
    dt = time.time() - t0
    fps = frames / dt

    assert np.isfinite(cs).all() and (np.abs(np.diff(cs)) > 0).any(), \
        "frames did not advance"
    print(f"# sanity: t={float(np.asarray(state.time)):.3f}s, "
          f"mean frame luma={cs.mean():.4f}", file=sys.stderr)

    def secondary(label, scene_s, n):
        roll_s = scene_s.jit_rollout(n, render=True)
        st, cs = roll_s(scene_s.init_state())
        np.asarray(cs)
        t0 = time.time()
        st, cs = roll_s(st)
        np.asarray(cs)
        f = n / (time.time() - t0)
        print(f"# secondary: {f:.1f} fps {label}", file=sys.stderr)
        return f

    # the reference app's own operating point: a 1280x720 window with
    # 4x MSAA (main.cpp:2502-2504) — measured both without and WITH
    # native per-sample 4x MSAA (ops/tiled_raster._tile_kernel)
    cfg720 = AppConfig()
    cfg720.render = RenderConfig(width=1280, height=720,
                                 shadow_map_size=shadow,
                                 show_skybox=False)
    secondary("at the reference's native 1280x720",
              Scene(static, ps, mo, cfg720), frames)

    cfg_msaa = AppConfig()
    cfg_msaa.render = RenderConfig(width=1280, height=720,
                                   shadow_map_size=shadow,
                                   show_skybox=False, msaa=4)
    secondary("at 1280x720 with msaa=4 (reference native quality)",
              Scene(static, ps, mo, cfg_msaa), 30)

    # textured path: per-part procedural textures through the shelf-
    # packed atlas (the reference binds a texture per part,
    # main.cpp:2093-2146)
    from simple_mmd_renderer.app.sample import (
        realistic_texture_sizes, sample_textures)
    cfg_tex = AppConfig()
    cfg_tex.render = RenderConfig(width=width, height=height,
                                  shadow_map_size=shadow,
                                  show_skybox=False)
    secondary("textured (2-part atlas) at 1920x1080",
              Scene(static, ps, mo, cfg_tex,
                    part_textures=sample_textures()), 30)

    cfg_tex720 = AppConfig()
    cfg_tex720.render = RenderConfig(width=1280, height=720,
                                     shadow_map_size=shadow,
                                     show_skybox=False)
    secondary("textured (2-part atlas) at the reference's 1280x720",
              Scene(static, ps, mo, cfg_tex720,
                    part_textures=sample_textures()), 30)

    # the reference's COMPLETE operating point: textured parts AND 4x
    # MSAA at its native 1280x720 window (main.cpp:2093-2146, 2502-2504)
    cfg_texms = AppConfig()
    cfg_texms.render = RenderConfig(width=1280, height=720,
                                    shadow_map_size=shadow,
                                    show_skybox=False, msaa=4)
    secondary("textured + msaa=4 at 1280x720 (full reference quality)",
              Scene(static, ps, mo, cfg_texms,
                    part_textures=sample_textures()), 30)

    # realistic texture load: 16 material parts, 2048^2-heavy size mix
    # (real PMX models ship 10-30 parts; the 2-part scene under-
    # represents part count and texel budget). The RECOMMENDED config
    # for this texel budget — and what this row measures — is the
    # resident mip mini-atlas (texture_mips + texture_resident): EXACT
    # (magnification-capped frames lax.cond to the big atlas,
    # PARITY.md D7), and it keeps the per-pixel gather table at ~17 MB
    # instead of a 256 MB level-0 atlas.
    import dataclasses
    pm16 = sample_character(density=density, n_parts=16)
    static16 = model_mod.build_model(pm16)
    mo16 = anim_mod.bind_motion(static16, sample_motion(240, fps_keys=5))
    ps16 = phys_mod.build_physics(static16)
    tex16 = sample_textures(realistic_texture_sizes(16))
    cfg_res = AppConfig()
    cfg_res.render = dataclasses.replace(cfg_tex.render, texture_mips=6,
                                         texture_resident=1)
    secondary("textured (16 parts, 2048^2-heavy mix, resident mips) "
              "at 1920x1080",
              Scene(static16, ps16, mo16, cfg_res,
                    part_textures=tex16), 30)

    # DIAGNOSTIC (not a target config): the same load sampling the
    # level-0 atlas directly (texture_mips=0) — tracked so a regression
    # in the plain path stays visible, but the supported answer for
    # 2048^2-heavy sets is the resident-mips row above.
    def diagnostic(label, scene_s, n):
        roll_s = scene_s.jit_rollout(n, render=True)
        st, cs = roll_s(scene_s.init_state())
        np.asarray(cs)
        t0 = time.time()
        st, cs = roll_s(st)
        np.asarray(cs)
        f = n / (time.time() - t0)
        print(f"# diagnostic (non-target config): {f:.1f} fps {label}",
              file=sys.stderr)
        return f

    diagnostic("textured 16 parts level-0 atlas (gather-wall "
               "diagnostic) at 1920x1080",
               Scene(static16, ps16, mo16, cfg_tex,
                     part_textures=tex16), 30)

    # large-mesh stress: 56k verts / 107k tris at 1080p (real stage /
    # detailed character scale; the reference's reader is
    # size-agnostic, pmx_reader_impl.inl:50-110)
    pm4 = sample_character(density=4.0)
    static4 = model_mod.build_model(pm4)
    mo4 = anim_mod.bind_motion(static4, sample_motion(240, fps_keys=5))
    ps4 = phys_mod.build_physics(static4)
    cfg4 = AppConfig()
    cfg4.render = RenderConfig(width=width, height=height,
                               shadow_map_size=shadow,
                               show_skybox=False)
    secondary("large mesh 56k verts / 107k tris at 1920x1080",
              Scene(static4, ps4, mo4, cfg4), 30)

    # BASELINE Config 5: 64 instances x independent motions (staggered
    # clocks), FUSED multi-instance raster (one binning sort + one
    # kernel launch across all instances), textured through the shared
    # atlas + native per-sample 4x MSAA, at a realistic crowd viewport.
    # Throughput unit is instance-frames/s (inst-fps): crowd fps x 64.
    import jax.numpy as jnp
    from simple_mmd_renderer.parallel import mesh as par
    cfg_crowd = AppConfig()
    cfg_crowd.render = RenderConfig(width=256, height=144,
                                    shadow_map_size=256,
                                    show_skybox=False, msaa=4)
    pm_c = sample_character(density=0.5)
    static_c = model_mod.build_model(pm_c)
    mo_c = anim_mod.bind_motion(static_c, sample_motion(120, fps_keys=5))
    ps_c = phys_mod.build_physics(static_c)
    scene_c = Scene(static_c, ps_c, mo_c, cfg_crowd,
                    part_textures=sample_textures())
    n_inst, n_cf = 64, 20
    step_c = par.crowd_step_fn(scene_c)

    def crowd_roll(state):
        def body(st, _):
            st, imgs = step_c(st)
            return st, jnp.mean(imgs)
        return jax.lax.scan(body, state, None, length=n_cf)

    roll_c = jax.jit(crowd_roll)
    st_c, cs_c = roll_c(par.crowd_init(scene_c, n_inst))
    np.asarray(cs_c)
    t0 = time.time()
    st_c, cs_c = roll_c(st_c)
    np.asarray(cs_c)
    inst_fps = n_cf * n_inst / (time.time() - t0)
    print(f"# secondary: {inst_fps:.0f} inst-fps crowd "
          f"({n_inst} instances, fused raster, textured + msaa=4) "
          f"at 256x144", file=sys.stderr)

    print(json.dumps({
        "metric": "fps_full_step_render_1080p",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / 60.0, 3),
        "device": device,
    }))


if __name__ == "__main__":
    main()
