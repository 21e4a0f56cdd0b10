"""Runtime configuration.

Every tunable the reference exposes through its ImGui windows, as a dataclass.
Defaults match the `g_state` initializers (`main.cpp:151-239`) and window
setup (`main.cpp:2502-2504`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _v(*xs):
    return field(default_factory=lambda: np.array(xs, np.float32))


@dataclass
class RenderConfig:
    # window / framebuffer (main.cpp:2502-2504)
    width: int = 1280
    height: int = 720
    clear_color: np.ndarray = _v(0.1, 0.1, 0.15)
    # reference renders with 4x MSAA (main.cpp:2504). msaa >= 4 runs TRUE
    # per-sample MSAA in the tiled raster kernel (4 rotated-grid samples per
    # pixel, shade-once-per-pixel, coverage resolve — like GPU hardware);
    # msaa_supersample=True forces the 2x2-supersample emulation instead
    # (also used automatically when the exact scan rasterizer is active).
    msaa: int = 1
    msaa_supersample: bool = False

    # camera (main.cpp:151-156; clip planes main.cpp:1897)
    camera_pos: np.ndarray = _v(0.2, 1.6, -4.0)
    camera_target: np.ndarray = _v(0.0, 1.1, 0.0)
    camera_fov_deg: float = 45.0
    # VMD camera tracks carry a per-key "perspective off" flag
    # (reader/vmd_reader_impl.inl:104, parsed but never consumed by the
    # reference); when True (or a traced bool from the camera track) the
    # projection is orthographic with the view height matched to the
    # perspective frustum at the look-at target (MMD's framing convention)
    camera_orthographic: bool = False
    near: float = 0.1
    far: float = 1000.0

    # directional light (main.cpp:228-233)
    light_direction: np.ndarray = field(default_factory=lambda: (
        np.array([0.3, -1.0, 0.2], np.float32)
        / np.linalg.norm([0.3, -1.0, 0.2])).astype(np.float32))
    light_color: np.ndarray = _v(1.0, 1.0, 1.0)
    light_intensity: float = 1.0

    # shadows (main.cpp:218, 232; frustum main.cpp:1996-2003)
    shadows_enabled: bool = True
    shadow_map_size: int = 2048
    shadow_frustum_half: float = 5.0
    shadow_near: float = 0.1
    shadow_far: float = 100.0
    # albedo texture gathers restricted to the character's screen bbox
    # (render.pipeline.character_albedo_windowed); False forces full-frame
    # sampling (perf comparison / debugging)
    albedo_window: bool = True
    # mip levels (incl. level 0) built into the packed texture atlas, with
    # per-TRIANGLE level selection baked into the deferred-UV rows
    # (render.pipeline.affine_uv_part_rows). 0/1 = off: bilinear from the
    # full-resolution texture, exactly the reference's sampler
    # (main.cpp:538 num_mipmaps=1, :1362 linear min/mag). >1 diverges from
    # the reference where textures minify — filtered instead of aliased —
    # and keeps gather addresses DRAM-local on large atlases (PARITY.md).
    texture_mips: int = 0
    # with texture_mips > 1: per frame, copy each part's needed mip level
    # into a fixed mini-atlas of ~20 MB (render.pipeline.resident_slot_size)
    # so the per-pixel gather reads a small table instead of the whole mip
    # atlas. EXACT: frames where any part would
    # need a finer level than its slot holds (magnification) fall back to
    # sampling the big atlas via lax.cond, so output always matches
    # texture_resident=0 (PARITY.md D7 closed). ON by default — it is a
    # pure fast path; degrades to off when the mip chain is too shallow
    # for the slot. 0 = off, 1/True = auto slot
    # (render.pipeline.resident_slot_size), >=64 = explicit slot edge.
    # Single-instance renders only (the fused crowd path samples the mip
    # atlas directly; crowd_render_supported).
    texture_resident: int = 1
    # validity-compacted prefix binning in the single-instance tiled raster
    # (ops/tiled_raster._bin_prefix): the bin sorts/gathers only the
    # smallest static prefix of valid-first compacted triangle ids that
    # covers the frame's survivor count (~half the mesh survives face
    # culling), selected per frame via lax.switch. Disabled automatically
    # on the crowd vmap fallback, where switch would run every rung.
    compact_bin: bool = True
    # ground shadow factor is sampled at 1/N resolution and bilinearly
    # upsampled (the 3x3 PCF is already a blur at that scale); 1 = exact
    # per-pixel lookup — one random gather into the lit map per pixel
    # instead of one per N x N block.
    shadow_lookup_downsample: int = 4

    # figure/resin material (main.cpp:235-239)
    rim_power: float = 2.0
    rim_intensity: float = 0.2
    rim_color: np.ndarray = _v(1.0, 1.0, 1.0)
    specular_power: float = 64.0
    specular_intensity: float = 1.0

    # rasterizer path: "tiled" (the binned tile kernel), "scan" (the exact
    # scan rasterizer) or "auto": tiled on the GPU, scan on the CPU
    raster_mode: str = "auto"

    # toon edge outlines (beyond-parity: the reference parses per-material
    # edge color/size and per-vertex edge scale but never draws them).
    # Rendered as an inverted hull: vertices displaced along normals by
    # 0.01 * edge_scale * material_edge_size * vertex_edge_scale MMD units,
    # back faces composited under the character.
    show_edges: bool = False
    edge_scale: float = 1.0
    # honor the per-material MAT_DOUBLE_FACE flag (skirts/ribbons render
    # from both sides, with viewer-facing normal flip). Beyond-parity: the
    # reference builds ONE back-culling pipeline and ignores the flag.
    double_sided: bool = False

    # skybox / ground
    show_skybox: bool = True
    show_ground: bool = True
    ground_size: float = 50.0          # main.cpp:868
    cubemap_size: int = 512            # main.cpp:1074

    # units (main.cpp:753-754)
    mmd_to_meter: float = 0.1


@dataclass
class PhysicsConfig:
    # mmd-bullet_impl.inl:64-89 + UI (main.cpp:1630-1696)
    enabled: bool = True
    gravity_strength: float = 9.8
    gravity_direction: np.ndarray = _v(0.0, -1.0, 0.0)
    world_scale: float = 10.0          # "world is scaled by 10"
    has_floor: bool = True
    floor_friction: float = 0.265
    # the reference never sets restitution on its ground body, so it keeps
    # Bullet's default 0 — combined body-vs-floor restitution is always 0
    floor_restitution: float = 0.0
    dt: float = 1.0 / 30.0             # main.cpp:1806
    substep_hz: float = 60.0           # stepSimulation internal step
    max_substeps: int = 60
    # XPBD iteration count. Fidelity is measured, not assumed
    # (scripts/solver_fidelity.py: RMS deviation of all dynamic bodies vs a
    # 32-iteration solve over the 4 s bench motion, MMD units, character
    # ~20 tall): iters 2 -> 0.453, 4 -> 0.220, 6 -> 0.156, 8 -> 0.122,
    # 16 -> 0.061. The elbow is at 4 (2->4 halves the error); 6 sits past
    # it at ~1.6 cm RMS on a 1.6 m character — swinging hair tips, where
    # phase drift dominates — while 6->8 buys 22% RMS for ~3% fps at the
    # bench point.
    solver_iterations: int = 6


@dataclass
class AppConfig:
    render: RenderConfig = field(default_factory=RenderConfig)
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)
    fps: float = 30.0                  # VMD frame rate (main.cpp:1793)
    animation_playing: bool = True
    # True spherical SDEF skinning (beyond-parity: the reference ships only
    # the BDEF2 matrix-lerp fallback, its true path is commented out at
    # poser_impl.inl:438-458). Default False = reference behavior.
    sdef_true: bool = False
    # Apply UV morphs and material morphs at render time (beyond-parity:
    # the reference parses both and applies neither, poser_impl.inl:355-358).
    apply_extended_morphs: bool = False
