"""Smoke run of the renderer on one GPU: the quickest proof that the system
starts and renders correctly on the card.

    python chip_smoke.py          # phases 1-7 on one GPU
    python chip_smoke.py --four   # the four-GPU mesh paths only

One process; every phase prints its compile and run seconds on its own line,
and any failed check raises (non-zero exit, no result line). The last line
is {"ok": true, "device": {...}}. Phases:

1. device: JAX's GPU, its kind and count, the card's name and power limit;
2. flagship: the bench scene (14k verts, 25.6k tris, physics) at 1920x1080
   with a 2048^2 shadow map through Scene.jit_rollout and Scene.jit_step;
3. parity on the card: tile kernel against the scan raster (main pass with
   attributes, shadow depth pass), the whole frame tiled against scan, and
   skinned positions against the CPU backend;
4. the reference's operating point: 1280x720, msaa=4, 2-part textures;
5. the 64-instance crowd at 256x144, msaa=4, textured, on the fused path;
6. each kernel variant against the scan raster (XLA's plain version) on the
   same inputs, plus the jnp PCF lit map;
7. the result line.

--four runs only the mesh paths on four GPUs, each against the same inputs
on one GPU: crowd_jit (instance axis sharded) and frame_jit (rows banded).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# the CPU backend stays reachable beside the GPU for the skinning check
if os.environ.get("JAX_PLATFORMS") and \
        "cpu" not in os.environ["JAX_PLATFORMS"].split(","):
    os.environ["JAX_PLATFORMS"] += ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# (width, height, shadow map, character density) of each phase's scene
FLAGSHIP = (1920, 1080, 2048, 2.0)
REFERENCE = (1280, 720, 2048, 2.0)
CROWD = (256, 144, 256, 0.5)
N_INST = 64
BANDED = (3840, 2160, 2048, 2.0)


def log(msg):
    print(msg, flush=True)


def timed(fn, *args):
    """-> (result, seconds) with the device work finished."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def median_ms(fn, *args, n=5):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def make_scene(density, width, height, shadow, textures=None, **render):
    from simple_mmd_renderer.app.sample import sample_character, sample_motion
    from simple_mmd_renderer.config import AppConfig, RenderConfig
    from simple_mmd_renderer.core import anim, model, physics
    from simple_mmd_renderer.core.scene import Scene
    static = model.build_model(sample_character(density=density))
    cfg = AppConfig()
    cfg.render = RenderConfig(width=width, height=height,
                              shadow_map_size=shadow, show_skybox=False,
                              **render)
    return Scene(static, physics.build_physics(static),
                 anim.bind_motion(static, sample_motion(240, fps_keys=5)),
                 cfg, part_textures=textures)


def assert_vis_close(got, ref, label):
    """The tolerances of tests/test_tiled_raster.py::_assert_vis_equal."""
    d = float(np.abs(np.asarray(got.depth) - np.asarray(ref.depth)).max())
    same = np.asarray(got.tri) == np.asarray(ref.tri)
    mism = float((~same).mean())
    bary = float(np.abs(np.asarray(got.bary) - np.asarray(ref.bary))[same]
                 .max())
    log(f"  {label}: max depth diff {d:.3g}, tri-id mismatch {mism:.3g}, "
        f"max bary diff {bary:.3g}")
    assert d <= 2e-5 and mism < 1e-3 and bary <= 2e-5, label
    return same


def phase_device(n_expected):
    from simple_mmd_renderer.utils.device import card_line, require_gpu
    d = require_gpu()
    assert d["count"] >= n_expected, f"need {n_expected} GPUs: {d}"
    log(f"phase 1 device: {d['platform']} {d['kind']} x{d['count']}")
    log(card_line())
    return d


def phase_flagship(frames=8, steps=3):
    from simple_mmd_renderer.ops import tiled_raster as tr
    from simple_mmd_renderer.render import pipeline, raster
    w, h, shadow, density = FLAGSHIP
    scene = make_scene(density, w, h, shadow)
    st = scene.static
    log(f"phase 2 flagship: {len(st.positions)} verts, {len(st.triangles)} "
        f"tris, {st.n_bones} bones, {scene.phys_static.n_bodies} bodies, "
        f"{scene.phys_static.n_joints} joints @ {w}x{h}, shadow {shadow}")
    roll = scene.jit_rollout(frames, render=True)
    (state, cs), t_compile = timed(roll, scene.init_state())
    (state, cs), t_run = timed(roll, state)
    cs = np.asarray(cs)
    assert np.isfinite(cs).all() and (np.abs(np.diff(cs)) > 0).any(), \
        "rollout frames did not advance"
    log(f"  jit_rollout({frames}): compile+first {t_compile:.2f}s, second "
        f"{t_run:.3f}s ({frames / t_run:.1f} fps device-side)")

    step = scene.jit_step()
    state = scene.init_state()
    t0 = time.perf_counter()
    state, img = step(state)
    img = np.asarray(img)
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        state, img = step(state)
        img = np.asarray(img)
    t_run = (time.perf_counter() - t0) / steps
    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    assert img.std() > 0.01, "flat frame"
    log(f"  jit_step -> host [H,W,3]: compile+first {t_compile:.2f}s, "
        f"{1e3 * t_run:.1f} ms/frame delivered ({1 / t_run:.1f} fps)")

    compiled = jax.jit(scene.step_and_render).lower(
        scene.init_state()).compile()
    ma = compiled.memory_analysis()
    log("  step memory_analysis: " + ", ".join(
        f"{k}={getattr(ma, k)}" for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(ma, k)))
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")

    # frame-0 geometry for the parity and timing phases
    _, _, pos, nrm = jax.jit(scene.step_pose)(scene.init_state())
    cfg = scene.config.render
    mats = pipeline.build_matrices(cfg, None, aspect=w / h)
    tris = jnp.asarray(st.triangles)[:, ::-1]
    clip = raster.transform_clip(pos * cfg.mmd_to_meter, mats["mvp"])
    sclip = raster.transform_clip(pos * cfg.mmd_to_meter, mats["light_mvp"])
    e_main = pipeline._tiled_e_max(w, h)
    e_shadow = pipeline._tiled_e_max(shadow, shadow)
    for label, c, cw, ch, cull, e in (
            ("main", clip, w, h, raster.CULL_BACK, e_main),
            ("shadow", sclip, shadow, shadow, raster.CULL_FRONT, e_shadow)):
        b = tr.binning_stats(c, tris, cw, ch, cull, e)
        log(f"  binning {label}: e_max {e}, {b['n_big']} big triangles, "
            f"{b['total_entries']} entries, max {b['max_tile_entries']}/tile")
        assert b["big_dropped"] == 0
    return scene, dict(pos=pos, nrm=nrm, tris=tris, clip=clip, sclip=sclip,
                       e_main=e_main, e_shadow=e_shadow,
                       light_vp=mats["light_vp"])


def phase_parity(scene, g):
    from simple_mmd_renderer.core.scene import Scene
    from simple_mmd_renderer.ops import tiled_raster as tr
    from simple_mmd_renderer.render import raster
    from simple_mmd_renderer.render.pipeline import render_frame
    tris, clip, sclip, nrm = g["tris"], g["clip"], g["sclip"], g["nrm"]
    w, h, shadow, _ = FLAGSHIP
    t0 = time.perf_counter()
    ref = jax.jit(lambda c: raster.rasterize(
        c, tris, w, h, raster.CULL_BACK))(clip)
    ref_attr = raster.interpolate(ref, clip, tris, nrm)
    vis, attr = tr.rasterize_attrs_tiled(clip, tris, nrm, w, h,
                                         raster.CULL_BACK, g["e_main"])
    same = assert_vis_close(vis, ref, f"main pass {w}x{h} tile vs scan")
    da = float(np.abs(np.asarray(attr) - np.asarray(ref_attr))[same].max())
    log(f"  main pass attributes: max diff {da:.3g}")
    assert da <= 2e-4
    ref_sh = jax.jit(lambda c: raster.rasterize(
        c, tris, shadow, shadow, raster.CULL_FRONT).depth)(sclip)
    got_sh = tr.rasterize_depth_tiled(sclip, tris, shadow, shadow,
                                      raster.CULL_FRONT, g["e_shadow"])
    dsh = float(np.abs(np.asarray(got_sh) - np.asarray(ref_sh)).max())
    log(f"  shadow pass {shadow}^2 tile vs scan: max depth diff {dsh:.3g}")
    assert dsh <= 2e-5

    cfg = scene.config.render
    frames = {}
    for mode in ("tiled", "scan"):
        c = dataclasses.replace(cfg, raster_mode=mode)
        frames[mode] = np.asarray(jax.jit(lambda p, n, c=c: render_frame(
            scene.static, p, n, c))(g["pos"], nrm))
    frac = float((np.abs(frames["tiled"] - frames["scan"]) > 0.02).mean())
    log(f"  whole frame tiled vs scan: {frac:.3g} of pixels differ by >0.02")
    assert frac < 2e-3

    # skinned positions after frame 0: GPU against the CPU backend, with
    # the float32 matmul scope and without it (the GPU may then use TF32).
    # Skinning proper is compared on ONE pose (the CPU's frame-0 pose); the
    # whole step also runs converged CCD IK, whose iterations amplify the
    # last-ulp differences of GPU transcendentals, so it is held to the
    # converged-CCD tolerance of tests/test_pose.py (5e-3 MMD units).
    from simple_mmd_renderer.core import pose as pose_mod
    from simple_mmd_renderer.utils.math3d import f32_matmul
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        s_cpu = jax.device_put(scene.init_state(), cpu)
        _, pose_cpu, pos_cpu, _ = jax.jit(scene.step_pose)(s_cpu)
        pose_cpu, pos_cpu = jax.device_get((pose_cpu, np.asarray(pos_cpu)))
    gpu = jax.devices()[0]
    deform = partial(pose_mod.deform, scene.static)
    skin = {label: float(np.abs(np.asarray(jax.jit(fn)(
        jax.device_put(pose_cpu, gpu))[0]) - pos_cpu).max())
        for label, fn in (("float32", f32_matmul(deform)),
                          ("default", deform))}
    raw = jax.jit(lambda s: Scene.step_pose.__wrapped__(scene, s))
    step = {"float32": float(np.abs(np.asarray(g["pos"]) - pos_cpu).max()),
            "default": float(np.abs(np.asarray(
                raw(scene.init_state())[2]) - pos_cpu).max())}
    log(f"  skinning one pose GPU vs CPU (MMD units): max diff "
        f"{skin['float32']:.3g} with float32 matmuls, {skin['default']:.3g} "
        f"without the setting")
    log(f"  whole frame-0 step GPU vs CPU (MMD units): max diff "
        f"{step['float32']:.3g} with float32 matmuls, {step['default']:.3g} "
        f"without the setting")
    assert skin["float32"] <= 1e-4 and step["float32"] <= 5e-3
    log(f"phase 3 parity: compile+run {time.perf_counter() - t0:.2f}s")


def phase_reference_point(frames=6):
    from simple_mmd_renderer.app.sample import sample_textures
    from simple_mmd_renderer.render import pipeline, raster
    w, h, shadow, density = REFERENCE
    scene = make_scene(density, w, h, shadow, textures=sample_textures(),
                       msaa=4)
    assert pipeline._pick_raster(scene.config.render) \
        is not raster.rasterize, "native MSAA needs the tile kernel"
    roll = scene.jit_rollout(frames, render=True)
    (state, cs), t_compile = timed(roll, scene.init_state())
    (state, cs), t_run = timed(roll, state)
    cs = np.asarray(cs)
    assert np.isfinite(cs).all() and (np.abs(np.diff(cs)) > 0).any()
    log(f"phase 4 {w}x{h} msaa=4 textured: compile+first {t_compile:.2f}s, "
        f"run {t_run:.3f}s for {frames} frames "
        f"({frames / t_run:.1f} fps device-side)")


def crowd_scene():
    from simple_mmd_renderer.app.sample import sample_textures
    w, h, shadow, density = CROWD
    return make_scene(density, w, h, shadow, textures=sample_textures(),
                      msaa=4)


def phase_crowd(frames=4):
    from simple_mmd_renderer.parallel import mesh as par
    from simple_mmd_renderer.render.pipeline import crowd_render_supported
    scene = crowd_scene()
    assert crowd_render_supported(scene.config.render, scene.part_textures,
                                  scene.cubemap, scene.camera), \
        "the crowd must take the fused path"
    step = par.crowd_step_fn(scene)

    def roll(state):
        def body(s, _):
            s, imgs = step(s)
            return s, jnp.mean(imgs)
        return jax.lax.scan(body, state, None, length=frames)

    roll = jax.jit(roll)
    (state, cs), t_compile = timed(roll, par.crowd_init(scene, N_INST))
    (state, cs), t_run = timed(roll, state)
    cs = np.asarray(cs)
    assert np.isfinite(cs).all() and (np.abs(np.diff(cs)) > 0).any()
    w, h = CROWD[:2]
    log(f"phase 5 crowd {N_INST} x {w}x{h} msaa=4 textured (fused): "
        f"compile+first {t_compile:.2f}s, run {t_run:.3f}s for {frames} "
        f"steps ({N_INST * frames / t_run:.0f} inst-fps device-side)")
    _, _, pos, nrm = jax.jit(jax.vmap(scene.step_pose))(state)
    return scene, pos, nrm


def phase_kernels(scene, g, crowd, card):
    """Each kernel variant against the scan raster on the same inputs:
    the whole pass (binning + kernel) and the kernel alone."""
    from simple_mmd_renderer.ops import tiled_raster as tr
    from simple_mmd_renderer.render import pipeline, raster
    from simple_mmd_renderer.render.shade import ground_lit_map
    t0 = time.perf_counter()
    tris, clip, sclip, nrm = g["tris"], g["clip"], g["sclip"], g["nrm"]
    w, h, shadow, _ = FLAGSHIP
    rw, rh = REFERENCE[:2]
    mats_r = pipeline.build_matrices(scene.config.render, None,
                                     aspect=rw / rh)
    clip_r = raster.transform_clip(g["pos"] * 0.1, mats_r["mvp"])
    e_r = pipeline._tiled_e_max(rw, rh)

    def kernel_alone(c, w, h, cull, e, attrs=None, **kw):
        s = raster.setup(c, tris, w, h, cull,
                         sample_extent=0.375 if kw.get("samples") else 0.0)
        if attrs is not None:
            s["va"] = attrs[tris]
        r = tr._setup_rows(s, jnp.arange(tris.shape[0], dtype=jnp.int32),
                           attrs)
        binned = jax.jit(lambda s_, r_: tr._bin(s_, r_, w, h, e)[:3])(s, r)
        return median_ms(jax.jit(lambda *b: tr._run_tiles(
            *b, 1, w, h, **kw)), *binned)

    cases = [
        (f"vis+3 attrs {w}x{h}",
         lambda: tr.rasterize_attrs_tiled(clip, tris, nrm, w, h,
                                          raster.CULL_BACK, g["e_main"]),
         lambda: kernel_alone(clip, w, h, raster.CULL_BACK, g["e_main"],
                              nrm, n_attrs=3),
         lambda: raster.rasterize(clip, tris, w, h, raster.CULL_BACK)),
        (f"depth-only {shadow}^2",
         lambda: tr.rasterize_depth_tiled(sclip, tris, shadow, shadow,
                                          raster.CULL_FRONT, g["e_shadow"]),
         lambda: kernel_alone(sclip, shadow, shadow, raster.CULL_FRONT,
                              g["e_shadow"], depth_only=True),
         lambda: raster.rasterize(sclip, tris, shadow, shadow,
                                  raster.CULL_FRONT).depth),
        (f"msaa4 vis+3 attrs {rw}x{rh}",
         lambda: tr.rasterize_attrs_tiled_msaa(clip_r, tris, nrm, rw, rh,
                                               raster.CULL_BACK, e_r),
         lambda: kernel_alone(clip_r, rw, rh, raster.CULL_BACK, e_r, nrm,
                              n_attrs=3, samples=4),
         lambda: raster.rasterize(clip_r, tris, rw, rh, raster.CULL_BACK)),
    ]
    cscene, cpos, cnrm = crowd
    cw, ch = CROWD[:2]
    cmats = pipeline.build_matrices(cscene.config.render, None,
                                    aspect=cw / ch)
    ctris = jnp.asarray(cscene.static.triangles)[:, ::-1]
    cclip = jax.vmap(lambda p: raster.transform_clip(p * 0.1,
                                                     cmats["mvp"]))(cpos)
    cases.append((
        f"crowd msaa4 vis+3 attrs {cpos.shape[0]} x {cw}x{ch}",
        lambda: tr.rasterize_attrs_tiled_msaa_crowd(
            cclip, ctris, cnrm, cw, ch, raster.CULL_BACK),
        None,
        lambda: jax.vmap(lambda c: raster.rasterize(
            c, ctris, cw, ch, raster.CULL_BACK))(cclip)))
    for name, tiled, alone, scan in cases:
        t_tiled = median_ms(jax.jit(tiled))
        t_alone = alone() if alone else float("nan")
        t_scan = median_ms(jax.jit(scan), n=2)
        log(f"  {name}: tiled pass {t_tiled:.3f} ms (kernel alone "
            f"{t_alone:.3f} ms), scan raster {t_scan:.1f} ms, "
            f"{t_scan / t_tiled:.0f}x")
    smap = tr.rasterize_depth_tiled(sclip, tris, shadow, shadow,
                                    raster.CULL_FRONT, g["e_shadow"])
    t_pcf = median_ms(jax.jit(lambda m: ground_lit_map(m, g["light_vp"])),
                      smap)
    log(f"  jnp PCF lit map {shadow}^2: {t_pcf:.3f} ms")
    log(f"phase 6 kernels vs XLA ({card}): "
        f"{time.perf_counter() - t0:.2f}s")


def phase_four():
    """crowd_jit and frame_jit on four GPUs against one GPU."""
    from __graft_entry__ import assert_banded_parity, assert_crowd_parity
    from simple_mmd_renderer.parallel import mesh as par
    mesh = par.make_mesh(jax.devices()[:4])

    scene = crowd_scene()
    cw, ch = CROWD[:2]
    crowd0 = par.crowd_init(scene, N_INST)
    step = par.crowd_jit(scene, mesh, render=True)
    (state, imgs), t_compile = timed(step, par.shard_crowd(crowd0, mesh))
    assert len(imgs.sharding.device_set) == 4
    _, t_run = timed(step, state)
    # body poses to 0.1 MMD units (1 cm): see assert_crowd_parity
    frac, pos_diff = assert_crowd_parity(scene, crowd0, state, imgs, cw, ch,
                                         pose_atol=0.1)
    log(f"four crowd_jit {N_INST} x {cw}x{ch} msaa=4 textured over 4 GPUs: "
        f"compile+first {t_compile:.2f}s, step {t_run:.3f}s; vs one GPU "
        f"{frac:.3g} of pixels differ by >0.02, body positions differ by "
        f"up to {pos_diff:.3g} MMD units")

    w, h, shadow, density = BANDED
    scene = make_scene(density, w, h, shadow)
    state0 = scene.init_state()
    fstep = par.frame_jit(scene, mesh)
    (state, img), t_compile = timed(fstep, state0)
    assert len(img.sharding.device_set) == 4
    _, t_run = timed(fstep, state0)
    frac = assert_banded_parity(scene, state0, state, img, w, h)
    log(f"four frame_jit {w}x{h} rows banded over 4 GPUs: compile+first "
        f"{t_compile:.2f}s, frame {t_run:.3f}s; vs one GPU {frac:.3g} of "
        f"pixels differ by >0.02")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh paths")
    args = ap.parse_args()
    from simple_mmd_renderer.utils.cache import enable_compilation_cache
    from simple_mmd_renderer.utils.device import card_line

    d = phase_device(4 if args.four else 1)
    enable_compilation_cache()
    card = card_line().splitlines()[0]
    if args.four:
        phase_four()
    else:
        scene, g = phase_flagship()
        phase_parity(scene, g)
        phase_reference_point()
        crowd = phase_crowd()
        phase_kernels(scene, g, crowd, card)
    log(card_line())
    print(json.dumps({"ok": True, "device": d}))


if __name__ == "__main__":
    main()
