"""Command-line renderer — the headless equivalent of the reference app's
`sokol_main` entry (`main.cpp:2483-2508`): arguments containing `.pmx` pick
the model, `.vmd` the motion (same substring matching), plus flags for frame
count, resolution and output. Renders PNG frames instead of a window.

Usage:
    python -m simple_mmd_renderer.app.cli model.pmx dance.vmd \
        --frames 90 --out /tmp/frames --width 1280 --height 720
    python -m simple_mmd_renderer.app.cli --sample --frames 30
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import time
import zlib

import numpy as np


def write_png(path: str, rgb: "np.ndarray") -> None:
    """[H,W,3] uint8 -> 8-bit RGB PNG (stdlib zlib; no image library)."""
    h, w = rgb.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    # filter type 0 (None) at the start of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(rgb, np.uint8).reshape(h, -1)],
                         axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def _pil_image():
    """PIL.Image, imported on first use: only GIF output needs it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise SystemExit("--gif needs Pillow (pip install pillow)") from e
    return Image


def ansi_frame(img: "np.ndarray", cols: int = 96) -> str:
    """[H,W,3] float image -> 24-bit-color half-block (U+2580) terminal
    frame: each character cell shows two vertical pixels (fg=upper,
    bg=lower). This is the trivial host viewer SURVEY.md 2.5 leaves
    optional — a live preview that works over any terminal, no window
    system required."""
    h, w = img.shape[:2]
    rows = max(2, (int(cols * h / w * 0.5) // 2) * 2)
    # nearest pixel at each cell center
    ys = ((np.arange(rows) + 0.5) * h / rows).astype(np.int64)
    xs = ((np.arange(cols) + 0.5) * w / cols).astype(np.int64)
    small = (np.clip(np.asarray(img)[ys][:, xs], 0.0, 1.0) * 255).astype(
        np.uint8)
    lines = []
    for y in range(0, rows, 2):
        cells = []
        for x in range(cols):
            tr, tg, tb = small[y, x]
            br, bg_, bb = small[y + 1, x]
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg_};{bb}m▀")
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


class OrbitRig:
    """Keyboard orbit camera for --watch: the headless counterpart of the
    reference's live mouse controller (`main.cpp:2370-2480` — LMB rotate
    with pitch clamped short of the poles, wheel zoom clamped 0.5-20 m,
    WASDQE fly, R reset). State lives host-side; the jitted step takes the
    camera as traced arguments, so steering never recompiles."""

    def __init__(self, rcfg):
        import numpy as np
        self._np = np
        self._home = (np.array(rcfg.camera_pos, np.float32).copy(),
                      np.array(rcfg.camera_target, np.float32).copy())
        self.reset()

    def reset(self):
        self.eye = self._home[0].copy()
        self.target = self._home[1].copy()

    def orbit(self, dyaw, dpitch):
        np = self._np
        off = self.eye - self.target
        r = float(np.linalg.norm(off))
        yaw = float(np.arctan2(off[0], off[2])) + dyaw
        pitch = float(np.arcsin(np.clip(off[1] / max(r, 1e-6), -1.0, 1.0)))
        pitch = float(np.clip(pitch + dpitch, -1.55, 1.55))
        self.eye = self.target + r * np.array(
            [np.cos(pitch) * np.sin(yaw), np.sin(pitch),
             np.cos(pitch) * np.cos(yaw)], np.float32)

    def zoom(self, dr):
        np = self._np
        off = self.eye - self.target
        r = float(np.linalg.norm(off))
        r2 = float(np.clip(r + dr, 0.5, 20.0))   # main.cpp:2446-2456 clamp
        self.eye = self.target + off / max(r, 1e-6) * r2

    def move(self, fwd=0.0, right=0.0, up=0.0):
        np = self._np
        f = self.target - self.eye
        f[1] = 0.0
        n = float(np.linalg.norm(f))
        f = f / n if n > 1e-6 else np.array([0, 0, 1], np.float32)
        rvec = np.array([f[2], 0.0, -f[0]], np.float32)
        d = (f * fwd + rvec * right
             + np.array([0, 1, 0], np.float32) * up).astype(np.float32)
        self.eye = self.eye + d
        self.target = self.target + d


KEY_HELP = "[arrows] orbit  [+/-] zoom  [wasdqe] fly  [r] reset  [x] quit"


def apply_keys(rig: OrbitRig, data: bytes) -> bool:
    """Apply pending key bytes to the rig; returns True on quit.

    An arrow key is 3 bytes (ESC [ X) and the poll boundary can split it;
    an incomplete trailing escape is stashed on the rig and prepended to
    the next call so fast key repeat never drops orbit presses."""
    data = getattr(rig, "_pending_keys", b"") + data
    rig._pending_keys = b""
    quit_ = False
    i = 0
    while i < len(data):
        c = data[i:i + 1]
        if c == b"\x1b" and len(data) - i < 3 \
                and data[i + 1:i + 2] in (b"", b"["):
            rig._pending_keys = data[i:]   # split escape — finish next poll
            break
        if c == b"\x1b" and data[i + 1:i + 2] == b"[":
            k = data[i + 2:i + 3]
            i += 3
            if k == b"A":
                rig.orbit(0.0, 0.12)
            elif k == b"B":
                rig.orbit(0.0, -0.12)
            elif k == b"C":
                rig.orbit(0.12, 0.0)
            elif k == b"D":
                rig.orbit(-0.12, 0.0)
            continue
        i += 1
        if c in (b"+", b"="):
            rig.zoom(-0.3)
        elif c == b"-":
            rig.zoom(0.3)
        elif c == b"w":
            rig.move(fwd=0.2)
        elif c == b"s":
            rig.move(fwd=-0.2)
        elif c == b"a":
            rig.move(right=-0.2)
        elif c == b"d":
            rig.move(right=0.2)
        elif c == b"q":
            rig.move(up=-0.2)
        elif c == b"e":
            rig.move(up=0.2)
        elif c in (b"r", b"R"):
            rig.reset()
        elif c in (b"x", b"X", b"\x03"):
            quit_ = True
    return quit_


class _RawStdin:
    """cbreak-mode stdin with non-blocking polling (restored on exit)."""

    def __enter__(self):
        import termios
        import tty
        self._termios = termios
        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        return self

    def poll(self) -> bytes:
        import select
        out = b""
        while select.select([sys.stdin], [], [], 0)[0]:
            chunk = os.read(self.fd, 64)
            if not chunk:
                break
            out += chunk
        return out

    def __exit__(self, *exc):
        self._termios.tcsetattr(self.fd, self._termios.TCSADRAIN, self.saved)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="*",
                    help=".pmx model and/or .vmd motion path")
    ap.add_argument("--sample", action="store_true",
                    help="use the procedural sample character + dance")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--out", default=None, help="PNG output directory")
    ap.add_argument("--gif", default=None, help="write an animated GIF")
    ap.add_argument("--use-camera", action="store_true",
                    help="drive the camera from the VMD camera track")
    ap.add_argument("--use-light", action="store_true",
                    help="drive the directional light from the VMD light "
                         "track (beyond-parity: the reference declares "
                         "LightMotionReader but never implements it)")
    ap.add_argument("--watch", action="store_true",
                    help="live ANSI preview in the terminal while rendering "
                         "(the headless stand-in for the reference's window)")
    ap.add_argument("--watch-cols", type=int, default=96,
                    help="terminal preview width in character cells")
    ap.add_argument("--hdr", default=None, help="equirect .hdr environment")
    ap.add_argument("--no-physics", action="store_true")
    ap.add_argument("--no-shadows", action="store_true")
    ap.add_argument("--shadow-size", type=int, default=2048)
    ap.add_argument("--msaa", type=int, default=1, choices=(1, 4),
                    help="4 = per-sample MSAA (the reference's native "
                         "quality, main.cpp:2504)")
    ap.add_argument("--sdef", action="store_true",
                    help="true spherical SDEF skinning (beyond-parity; "
                         "default is the reference's BDEF2 fallback)")
    ap.add_argument("--edges", action="store_true",
                    help="toon edge outlines from the PMX edge data "
                         "(beyond-parity; the reference never draws them)")
    ap.add_argument("--edge-scale", type=float, default=1.0)
    ap.add_argument("--double-sided", action="store_true",
                    help="honor MAT_DOUBLE_FACE (skirts/ribbons render from "
                         "both sides; the reference ignores the flag)")
    ap.add_argument("--mmd-shading", action="store_true",
                    help="toon ramps + SPH/SPA sphere maps (beyond-parity; "
                         "the reference's shader ignores them)")
    ap.add_argument("--density", type=float, default=1.0,
                    help="sample mesh density")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a device profile of the render loop to "
                         "DIR (jax.profiler; view in xprof/TensorBoard). "
                         "Render passes appear under their pass_scope "
                         "labels — the reference's sg_push_debug_group "
                         "groups, main.cpp:2014/2055/2192")
    ap.add_argument("--save-state", default=None, metavar="PATH",
                    help="write the sim state (time + physics pytree) to "
                         "PATH.npz when the run ends; --resume continues "
                         "from it bit-identically")
    ap.add_argument("--save-every", type=int, default=0, metavar="N",
                    help="with --save-state: also checkpoint every N "
                         "frames (crash-safe long renders)")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="restore the sim state saved by --save-state and "
                         "continue from it")
    ap.add_argument("--pose", default=None, metavar="PATH",
                    help="apply a .vpd pose file (held for the whole run; "
                         "combined with a .vmd, it fills bones/morphs the "
                         "motion does not key)")
    ap.add_argument("--warm", action="store_true",
                    help="compile the configured pipeline (populating the "
                         "persistent .jax_cache), render one frame, and "
                         "exit — later processes with the same flags start "
                         "in seconds instead of minutes")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from ..utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from ..config import AppConfig, RenderConfig
    from ..core import anim as anim_mod
    from ..core import model as model_mod
    from ..core import physics as phys_mod
    from ..core.scene import Scene
    from ..formats import pmx as pmx_mod
    from ..formats import vmd as vmd_mod
    from ..formats.hdr import load_hdr
    from ..formats.textures import load_material_textures
    from ..render import ibl

    model_path = next((p for p in args.paths
                       if ".pmx" in p.lower() or ".pmd" in p.lower()), None)
    motion_path = next((p for p in args.paths if ".vmd" in p.lower()), None)

    if args.sample or model_path is None:
        from .sample import sample_character, sample_motion
        print("using procedural sample character")
        pm = sample_character(args.density)
        motion = sample_motion(args.frames * 2)
        textures = None
        model_dir = "."
    else:
        print(f"loading model: {model_path}")
        if ".pmd" in model_path.lower():
            from ..formats.pmd import load_pmd
            pm = load_pmd(model_path)
        else:
            pm = pmx_mod.load_pmx(model_path)
        model_dir = os.path.dirname(os.path.abspath(model_path))
        motion = vmd_mod.load_vmd(motion_path) if motion_path else None
        textures = True

    pose_path = args.pose or next(
        (p for p in args.paths if ".vpd" in p.lower()), None)
    if pose_path:
        from ..formats.vpd import load_vpd
        vpd = load_vpd(pose_path)
        if motion is None:
            motion = vpd
            print(f"holding pose from {pose_path} "
                  f"({len(vpd.bone_tracks)} bones, "
                  f"{len(vpd.morph_tracks)} morphs)")
        else:
            added = sum(
                motion.bone_tracks.setdefault(n, t) is t
                for n, t in vpd.bone_tracks.items()) + sum(
                motion.morph_tracks.setdefault(n, t) is t
                for n, t in vpd.morph_tracks.items())
            print(f"pose {pose_path}: filled {added} tracks the motion "
                  f"does not key")

    static = model_mod.build_model(pm)
    print(f"model '{static.name}': {len(static.positions)} verts, "
          f"{len(static.triangles)} tris, {static.n_bones} bones, "
          f"{len(pm.rigid_bodies)} bodies, {len(pm.constraints)} joints")

    part_textures = (load_material_textures(static, model_dir)
                     if textures else None)
    mo = anim_mod.bind_motion(static, motion) if motion else None
    ps = phys_mod.build_physics(static)

    cfg = AppConfig()
    cfg.render = RenderConfig(width=args.width, height=args.height,
                              shadow_map_size=args.shadow_size,
                              shadows_enabled=not args.no_shadows,
                              msaa=args.msaa, show_edges=args.edges,
                              edge_scale=args.edge_scale,
                              double_sided=args.double_sided)
    cfg.physics.enabled = not args.no_physics
    cfg.sdef_true = args.sdef

    cubemap = None
    if args.hdr and os.path.isfile(args.hdr):
        print(f"loading HDR environment: {args.hdr}")
        cubemap = np.asarray(ibl.equirect_to_cubemap(
            jnp.asarray(load_hdr(args.hdr)), cfg.render.cubemap_size))
    else:
        cfg.render.show_skybox = cubemap is not None

    camera = None
    if args.use_camera and motion is not None and motion.camera is not None:
        from ..render.camera_anim import bind_camera
        camera = bind_camera(motion.camera)
        print("camera driven by VMD camera track")
    light = None
    if args.use_light and motion is not None and motion.light is not None:
        from ..render.camera_anim import bind_light
        light = bind_light(motion.light)
        print("light driven by VMD light track")
    mmd_maps = None
    if args.mmd_shading:
        from ..formats.textures import load_sphere_maps, load_toon_ramps
        sph, modes = load_sphere_maps(static, model_dir)
        mmd_maps = (sph, modes, load_toon_ramps(static, model_dir))
        print("MMD extended shading: toon ramps + sphere maps")
    scene = Scene(static, ps, mo, cfg, part_textures=part_textures,
                  cubemap=cubemap, camera=camera, light=light,
                  mmd_maps=mmd_maps)
    state = scene.init_state()
    if args.resume:
        from ..utils.checkpoint import load_state
        state = load_state(args.resume, state)
        print(f"resumed sim state from {args.resume} "
              f"(t={float(state.time):.3f}s)")
    # --watch on a tty gets the live orbit camera (keyboard counterpart of
    # the reference's mouse controller); the camera rides the jitted step
    # as traced arguments, so steering never recompiles
    interactive = args.watch and sys.stdin.isatty() and camera is None
    if interactive:
        rig = OrbitRig(cfg.render)
        fov = float(cfg.render.camera_fov_deg)
        atlas = scene.packed_atlas()
        base_step = jax.jit(
            lambda s, cam, atl: scene.step_and_render(
                s, camera_override=cam, atlas=atl))

        def step(s):
            return base_step(s, (jnp.asarray(rig.eye),
                                 jnp.asarray(rig.target),
                                 jnp.float32(fov)), atlas)
    else:
        step = scene.jit_step(render=True)

    print(f"compiling for {args.width}x{args.height} "
          f"on {jax.devices()[0].platform}...")
    t0 = time.time()
    # The first execution includes the device compile, which can take
    # minutes at large sizes; keep a heartbeat printing so a long compile
    # does not read as a hang.
    import threading
    done = threading.Event()

    def heartbeat():
        while not done.wait(15.0):
            print(f"  ... still compiling ({time.time() - t0:.0f}s elapsed; "
                  "first device compile can take minutes)", flush=True)

    hb = threading.Thread(target=heartbeat, daemon=True)
    hb.start()
    try:
        state, image = step(state)
        image.block_until_ready()
    finally:
        done.set()
    print(f"first frame (compile): {time.time() - t0:.1f}s")
    if args.warm:
        # executables above the 1 s compile threshold are now in the
        # persistent cache (utils/cache.py) keyed by config+backend;
        # a repeat process with these flags skips the device compile
        print("cache warmed; exiting (--warm)")
        return 0

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    gif_frames = []
    # live frame statistics (the reference's sgimgui stats window,
    # main.cpp:1699): rolling fps / frame-ms shown in the --watch footer
    # and in the final summary. tick() is called where the frame is
    # host-materialized, so the numbers reflect real frame delivery.
    from ..utils.profiling import FrameStats, trace
    stats = FrameStats(window=60)

    def save(i, img):
        if args.out or args.gif:
            rgb = (np.asarray(img) * 255).astype(np.uint8)
            if args.out:
                write_png(os.path.join(args.out, f"frame_{i:05d}.png"), rgb)
            if args.gif:
                gif_frames.append(_pil_image().fromarray(rgb))
        if args.watch:
            # home the cursor and repaint in place (clear once up front)
            prefix = "\x1b[2J\x1b[H" if i == 0 else "\x1b[H"
            hud = (f"frame {i:5d}  {stats.fps:6.1f} fps  "
                   f"{stats.frame_ms:6.1f} ms/frame")
            tail = ("\n" + hud + "  " + KEY_HELP + "\n") if interactive \
                else ("\n" + hud + "\n")
            sys.stdout.write(prefix + ansi_frame(np.asarray(img),
                                                 args.watch_cols) + tail)
            sys.stdout.flush()
        stats.tick()

    def checkpoint(i, force=False):
        if args.save_state and (force or (args.save_every
                                          and i % args.save_every == 0)):
            from ..utils.checkpoint import save_state
            save_state(args.save_state, state)

    save(0, image)
    t0 = time.time()
    import contextlib
    tracer = trace(args.trace) if args.trace else contextlib.nullcontext()
    with tracer:
        if interactive:
            with _RawStdin() as keys:
                for i in range(1, args.frames):
                    if apply_keys(rig, keys.poll()):
                        break
                    state, image = step(state)
                    save(i, image)
                    checkpoint(i)
        else:
            for i in range(1, args.frames):
                state, image = step(state)
                save(i, image)
                checkpoint(i)
        image.block_until_ready()
    dt = time.time() - t0
    n = max(args.frames - 1, 1)
    print(f"{n} frames in {dt:.2f}s -> {n / dt:.1f} fps"
          + (f" (rolling: {stats.fps:.1f} fps, {stats.frame_ms:.1f} "
             f"ms/frame)" if stats.times else ""))
    if args.trace:
        print(f"device profile written to {args.trace}")
    checkpoint(args.frames - 1, force=True)
    if args.save_state:
        print(f"sim state saved to {args.save_state} "
              f"(t={float(state.time):.3f}s); continue with "
              f"--resume {args.save_state}")
    if args.gif and gif_frames:
        gif_frames[0].save(args.gif, save_all=True,
                           append_images=gif_frames[1:],
                           duration=int(1000 / 30), loop=0)
        print(f"wrote {args.gif} ({len(gif_frames)} frames)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
