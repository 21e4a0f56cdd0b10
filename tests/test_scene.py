import numpy as np
import jax
import jax.numpy as jnp

from simple_mmd_renderer.app.sample import sample_character, sample_motion
from simple_mmd_renderer.config import AppConfig, RenderConfig
from simple_mmd_renderer.core import anim as A
from simple_mmd_renderer.core import model as M
from simple_mmd_renderer.core import physics as PH
from simple_mmd_renderer.core.scene import Scene
from simple_mmd_renderer.utils.checkpoint import save_state, load_state


def _scene(render=True):
    pm = sample_character(density=0.3)
    static = M.build_model(pm)
    mo = A.bind_motion(static, sample_motion(60, fps_keys=10))
    ps = PH.build_physics(static)
    cfg = AppConfig()
    cfg.render = RenderConfig(width=80, height=60, shadow_map_size=64,
                              show_skybox=False, raster_mode="scan")
    cfg.physics.solver_iterations = 4
    return Scene(static, ps, mo, cfg)


def test_scene_steps_and_renders():
    scene = _scene()
    state = scene.init_state()
    step = scene.jit_step(render=True, donate=False)
    imgs = []
    for _ in range(3):
        state, img = step(state)
        imgs.append(np.asarray(img))
    assert imgs[0].shape == (60, 80, 3)
    for img in imgs:
        assert np.isfinite(img).all()
    # frames advance: character animates
    assert np.abs(imgs[0] - imgs[2]).max() > 0.01
    # clock advanced at 30 fps semantics (main.cpp:1793)
    np.testing.assert_allclose(float(state.time), 3 / 30.0, atol=1e-6)
    # character covers some of the frame
    clear = np.array([0.1, 0.1, 0.15])
    assert (np.abs(imgs[-1] - clear).sum(-1) > 0.05).mean() > 0.2


def test_scene_rollout_matches_stepping():
    scene = _scene()
    state = scene.init_state()
    roll = jax.jit(lambda s: scene.rollout(s, 4, render=False))
    end_state, sums = roll(state)
    # step-by-step
    s = scene.init_state()
    step = scene.jit_step(render=False, donate=False)
    for i in range(4):
        s, pose, pos, nrm = step(s)
        np.testing.assert_allclose(float(jnp.mean(pos)), float(sums[i]),
                                   atol=2e-4)
    np.testing.assert_allclose(np.asarray(end_state.physics.pos),
                               np.asarray(s.physics.pos), atol=2e-3)


def test_scene_checkpoint_resume(tmp_path):
    import os
    scene = _scene()
    step = scene.jit_step(render=False, donate=False)
    state = scene.init_state()
    for _ in range(3):
        state, *_ = step(state)
    path = os.path.join(tmp_path, "scene.npz")
    save_state(path, state)
    restored = load_state(path, scene.init_state())
    a, *_ = step(state)
    b, *_ = step(restored)
    np.testing.assert_array_equal(np.asarray(a.physics.pos),
                                  np.asarray(b.physics.pos))


def test_cli_smoke(tmp_path):
    from simple_mmd_renderer.app import cli
    rc = cli.main(["--sample", "--frames", "2", "--width", "64",
                   "--height", "48", "--shadow-size", "32",
                   "--density", "0.25", "--out", str(tmp_path)])
    assert rc == 0
    import os
    assert os.path.isfile(os.path.join(tmp_path, "frame_00000.png"))
    assert os.path.isfile(os.path.join(tmp_path, "frame_00001.png"))


def test_scene_with_camera_track():
    from simple_mmd_renderer.formats import vmd as V
    from simple_mmd_renderer.formats.writers import write_vmd
    from simple_mmd_renderer.render.camera_anim import bind_camera
    scene = _scene()
    data = write_vmd("cam", [], [], camera_keys=[
        {"frame": 0, "position": (0, 12, 0), "focal_length": -35.0,
         "fov": 30.0},
        {"frame": 60, "position": (4, 12, 0), "focal_length": -35.0,
         "fov": 45.0}])
    cam_motion = V.parse_vmd(data)
    scene.camera = bind_camera(cam_motion.camera)
    state = scene.init_state()
    step = scene.jit_step(render=True, donate=False)
    state, img1 = step(state)
    for _ in range(8):
        state, img2 = step(state)
    assert np.isfinite(np.asarray(img2)).all()
    # camera moved -> framing changes even beyond animation differences
    assert np.abs(np.asarray(img1) - np.asarray(img2)).mean() > 1e-3


def test_seek_scrub_resets_physics():
    """Scrubbing the clock (main.cpp:2273-2290) must not integrate rigid
    bodies through the discontinuity: seek-to-t after playback equals
    seek-to-t from a fresh state (both re-seed physics at the pose of t,
    like the reference's Reset, mmd-bullet_impl.inl:285-310)."""
    scene = _scene()
    step = scene.jit_step(render=False, donate=False)

    s = scene.init_state()
    for _ in range(10):
        s, *_ = step(s)
    scrubbed = scene.seek(s, 0.1)
    fresh = scene.seek(scene.init_state(), 0.1)
    np.testing.assert_allclose(float(scrubbed.time), 0.1, atol=1e-6)
    np.testing.assert_allclose(np.asarray(scrubbed.physics.pos),
                               np.asarray(fresh.physics.pos), atol=1e-6)
    np.testing.assert_allclose(np.asarray(scrubbed.physics.vel),
                               np.asarray(fresh.physics.vel), atol=1e-6)
    # stepping from the scrubbed state agrees with the fresh path too
    a, b = scrubbed, fresh
    for _ in range(3):
        a, *_ = step(a)
        b, *_ = step(b)
    np.testing.assert_allclose(np.asarray(a.physics.pos),
                               np.asarray(b.physics.pos), atol=1e-6)


def test_orthographic_camera_renders():
    """The VMD camera 'perspective off' flag selects an orthographic
    projection (vs the reference, which parses the flag and drops it)."""
    import dataclasses
    from simple_mmd_renderer.render.pipeline import (build_matrices,
                                                         render_frame)
    scene = _scene()
    state = scene.init_state()
    _, pose, pos, nrm = scene.step_pose(state)
    cfg = scene.config.render
    cfg_o = dataclasses.replace(cfg, camera_orthographic=True)
    # ortho projection has no perspective divide row
    mats = build_matrices(cfg_o)
    np.testing.assert_allclose(np.asarray(mats["proj"])[3],
                               [0, 0, 0, 1], atol=1e-6)
    img_p = np.asarray(render_frame(scene.static, pos, nrm, cfg))
    img_o = np.asarray(render_frame(scene.static, pos, nrm, cfg_o))
    assert np.isfinite(img_o).all()
    assert np.abs(img_p - img_o).mean() > 1e-3  # projection changed framing
    # a traced flag (the camera-track path) selects the same matrices
    cfg_t = dataclasses.replace(cfg, camera_orthographic=jnp.asarray(True))
    mats_t = build_matrices(cfg_t)
    np.testing.assert_allclose(np.asarray(mats_t["proj"]),
                               np.asarray(mats["proj"]), atol=1e-6)


def test_orbit_rig_keys_and_camera_override():
    """The --watch live camera: host-side orbit rig semantics (reference
    controller, main.cpp:2370-2480) and the traced camera_override path."""
    from simple_mmd_renderer.app.cli import OrbitRig, apply_keys
    rcfg = RenderConfig()
    rig = OrbitRig(rcfg)
    e0 = rig.eye.copy()
    assert not apply_keys(rig, b"\x1b[C\x1b[A+w")   # orbit, zoom, fly
    assert np.abs(rig.eye - e0).max() > 0.05
    d0 = np.linalg.norm(rig.eye - rig.target)
    for _ in range(100):
        apply_keys(rig, b"+")                        # zoom clamps at 0.5 m
    d1 = np.linalg.norm(rig.eye - rig.target)
    assert 0.5 - 1e-4 <= d1 < d0
    apply_keys(rig, b"r")
    np.testing.assert_allclose(rig.eye, e0, atol=1e-6)
    assert apply_keys(rig, b"x")                     # quit

    scene = _scene()
    state = scene.init_state()
    step = jax.jit(
        lambda s, cam: scene.step_and_render(s, camera_override=cam))
    cam1 = (jnp.asarray([0.2, 1.6, -4.0]), jnp.asarray([0.0, 1.1, 0.0]),
            jnp.float32(45.0))
    cam2 = (jnp.asarray([3.0, 1.6, -2.0]), jnp.asarray([0.0, 1.1, 0.0]),
            jnp.float32(45.0))
    _, img1 = step(state, cam1)
    _, img2 = step(state, cam2)
    assert np.isfinite(np.asarray(img1)).all()
    assert np.abs(np.asarray(img1) - np.asarray(img2)).mean() > 1e-3


def test_scene_with_light_track():
    """Animated directional light (VMD light section): color/direction ride
    the jitted step as traced samples — the capability the reference's
    light_motion_reader.inl declares but never implements."""
    import dataclasses

    from simple_mmd_renderer.formats import vmd as V
    from simple_mmd_renderer.formats.writers import write_vmd
    from simple_mmd_renderer.render.camera_anim import bind_light
    # rim off: the flat-white sample character (albedo=1) otherwise clips
    # every channel at 1.0 (0.9 base + rim), which would erase the tint;
    # light from the camera side so visible normals get ndotl > 0
    direction = (0.3, -0.4, 1.0)
    scene = _scene()
    scene.config.render = dataclasses.replace(
        scene.config.render, rim_intensity=0.0, light_direction=direction)
    data = write_vmd("li", [], [], light_keys=[
        {"frame": 0, "color": (1, 1, 1), "direction": direction},
        {"frame": 6, "color": (1, 0, 0), "direction": direction}])
    scene.light = bind_light(V.parse_vmd(data).light)
    control = _scene()  # identical scene, no light track
    control.config.render = dataclasses.replace(
        control.config.render, rim_intensity=0.0, light_direction=direction)
    state, cstate = scene.init_state(), control.init_state()
    step = scene.jit_step(render=True, donate=False)
    cstep = control.jit_step(render=True, donate=False)
    for _ in range(8):
        state, img = step(state)
        cstate, cimg = cstep(cstate)
    img, cimg = np.asarray(img), np.asarray(cimg)
    assert np.isfinite(img).all()
    # by frame 8 the track is fully red at a new direction; the animation is
    # identical in both scenes so any difference is the animated light
    assert np.abs(img - cimg).max() > 1e-3
    # red light: some character pixel gains red over green (diffuse term is
    # light_color * 0.25 * ndotl, main.glsl:108-113) vs the white control
    rg = img[..., 0] - img[..., 1]
    crg = cimg[..., 0] - cimg[..., 1]
    assert rg.max() > crg.max() + 1e-6


def test_apply_keys_split_escape_across_polls():
    """An arrow key's 3-byte escape sequence split across two poll() reads
    must still orbit (the incomplete tail is stashed and finished on the
    next call), and a lone mid-stream ESC stays a no-op."""
    from simple_mmd_renderer.app.cli import OrbitRig, apply_keys
    from simple_mmd_renderer.config import RenderConfig as RC

    rig = OrbitRig(RC())
    whole = OrbitRig(RC())
    assert not apply_keys(whole, b"\x1b[C")
    # split after ESC
    assert not apply_keys(rig, b"\x1b")
    assert not apply_keys(rig, b"[C")
    np.testing.assert_allclose(rig.eye, whole.eye, rtol=1e-6)
    # split after ESC [
    rig2 = OrbitRig(RC())
    assert not apply_keys(rig2, b"\x1b[")
    assert not apply_keys(rig2, b"C")
    np.testing.assert_allclose(rig2.eye, whole.eye, rtol=1e-6)
    # lone ESC mid-stream does not eat following keys
    rig3 = OrbitRig(RC())
    e0 = rig3.eye.copy()
    assert not apply_keys(rig3, b"\x1bw")
    assert not np.allclose(rig3.eye, e0)


def test_seek_jit_is_cached_per_scene():
    """Scene.seek compiles once per Scene: repeated scrubs reuse the same
    jitted function instead of re-tracing per call."""
    scene = _scene()
    st = scene.init_state()
    s1 = scene.seek(st, 0.5)
    fn1 = scene._seek_jit
    s2 = scene.seek(st, 1.25)
    assert scene._seek_jit is fn1
    assert float(s2.time) != float(s1.time)


def test_packed_atlas_invalidates_on_inplace_texture_replacement():
    """Scene.packed_atlas caches; replacing a texture IN PLACE in the list
    (same list object) must rebuild, not serve the stale atlas."""
    from simple_mmd_renderer.app.sample import sample_textures

    scene = _scene()
    scene.part_textures = sample_textures(sizes=(16, 8))
    a0 = scene.packed_atlas()
    assert scene.packed_atlas() is a0           # cache hit, same inputs
    new0 = np.full_like(scene.part_textures[0], 128 / 255)  # 8-bit grid
    scene.part_textures[0] = new0               # in-place element swap
    a1 = scene.packed_atlas()
    assert a1 is not a0
    assert (np.asarray(a1.data).shape != np.asarray(a0.data).shape
            or not np.array_equal(np.asarray(a1.data), np.asarray(a0.data)))
