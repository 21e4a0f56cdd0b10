"""Scene: model + motion + physics + renderer, stepped as one jitted program.

The per-frame orchestration mirrors `frame()` in the reference app
(`main.cpp:1755-1825`):

    time += dt; frame = time * 30
    ResetPosing -> SeekFrame -> PrePhysicsPosing -> React(1/30)
    -> PostPhysicsPosing -> Deform -> render

Everything per-frame is one pure function of (SimState, static data), so a
scene jits once and vmaps over instances for crowds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp

from ..config import AppConfig
from ..render.pipeline import render_frame
from ..utils import pytree
from ..utils.math3d import f32_matmul
from ..utils.profiling import pass_scope
from . import anim as anim_mod
from . import physics as phys_mod
from . import pose as pose_mod
from .anim import MotionArrays
from .model import ModelStatic
from .physics import PhysicsState, PhysicsStatic


@pytree.dataclass
class SimState:
    time: jnp.ndarray            # f32 scalar, seconds
    physics: PhysicsState


@dataclass
class Scene:
    static: ModelStatic
    phys_static: PhysicsStatic
    motion: MotionArrays | None = None
    config: AppConfig = field(default_factory=AppConfig)
    part_textures: list | None = None
    cubemap: jnp.ndarray | None = None
    camera: object | None = None  # render.camera_anim.CameraArrays
    # render.camera_anim.LightArrays — VMD light track (the capability the
    # reference's light_motion_reader.inl declares but never implements)
    light: object | None = None
    # (sphere_textures, sphere_modes, toon_ramps) from
    # formats.textures.load_sphere_maps/load_toon_ramps — enables the
    # beyond-parity MMD toon/SPH/SPA shading path when set
    mmd_maps: tuple | None = None

    def packed_atlas(self):
        """Device-packed texture atlas (render.pipeline.PackedAtlas), built
        once and passed through jit as an ARGUMENT: large texture sets
        (16 parts at 2048^2 pack to hundreds of MB) must not be baked into
        the traced program as constants — constant-folding them bloats
        every lowering and compile."""
        if self.part_textures is None:
            return None
        mips = int(self.config.render.texture_mips)
        # cache key includes each element's identity, not just the list's:
        # replacing a texture IN PLACE (scene.part_textures[i] = new) must
        # invalidate, or a stale atlas is served silently
        key = (id(self.part_textures),
               tuple(id(t) for t in self.part_textures), mips)
        if getattr(self, "_atlas_src", None) != key:
            from ..render.pipeline import build_packed_atlas
            object.__setattr__(self, "_atlas",
                               build_packed_atlas(self.part_textures,
                                                  mip_levels=mips))
            object.__setattr__(self, "_atlas_src", key)
        return self._atlas

    def init_state(self) -> SimState:
        # jitted: eagerly this is thousands of tiny dispatches (neutral-pose
        # FK/IK + physics seed) — as one compiled program it is one launch
        @jax.jit
        def _init():
            pose = self._neutral_pose()
            return SimState(
                time=jnp.float32(0.0),
                physics=phys_mod.physics_reset(self.phys_static, pose))

        return _init()

    def _neutral_pose(self):
        b = self.static.n_bones
        rot = jnp.broadcast_to(jnp.asarray([0, 0, 0, 1.0], jnp.float32), (b, 4))
        trans = jnp.zeros((b, 3), jnp.float32)
        rates = jnp.zeros((self.static.n_morphs,), jnp.float32)
        return pose_mod.pre_physics_posing(self.static, rot, trans, rates)

    def _sample_anim(self, time):
        """Motion pose inputs at `time` seconds (neutral without motion)."""
        static = self.static
        frame = jnp.floor(time * self.config.fps)
        if self.motion is not None:
            return anim_mod.sample_motion(self.motion, frame)
        b = static.n_bones
        anim_rot = jnp.broadcast_to(
            jnp.asarray([0, 0, 0, 1.0], jnp.float32), (b, 4))
        anim_trans = jnp.zeros((b, 3), jnp.float32)
        rates = jnp.zeros((static.n_morphs,), jnp.float32)
        return anim_rot, anim_trans, rates

    def seek(self, state: SimState, t) -> SimState:
        """Jump the animation clock to `t` seconds — the API form of the
        reference's sequencer scrub (`main.cpp:2273-2290` re-syncs time on a
        manual drag). A scrub discards in-flight rigid-body dynamics:
        physics re-seeds from the animation pose at the new time exactly
        like the reference's Reset (`mmd-bullet_impl.inl:285-310`), so
        hair/skirts do not integrate through the time discontinuity."""
        # compile once per Scene: an interactive scrub calls seek per drag
        # tick, and a fresh jit closure each call would re-trace every time
        fn = getattr(self, "_seek_jit", None)
        if fn is None:
            @jax.jit
            def fn(t):
                anim_rot, anim_trans, rates = self._sample_anim(t)
                pose = pose_mod.pre_physics_posing(self.static, anim_rot,
                                                   anim_trans, rates)
                return SimState(
                    time=t,
                    physics=phys_mod.physics_reset(self.phys_static, pose))
            object.__setattr__(self, "_seek_jit", fn)

        return fn(jnp.float32(t))

    @f32_matmul
    def step_pose(self, state: SimState):
        """One animation+physics frame -> (state', pose, positions, normals).

        positions/normals are the deformed vertices in MMD units."""
        static = self.static
        cfg = self.config
        time = state.time + jnp.float32(1.0 / cfg.fps)

        # pass_scope labels (utils/profiling.py) name the sim stages in
        # profiler traces — the reference's debug groups, main.cpp:2014+
        with pass_scope("anim"):
            anim_rot, anim_trans, rates = self._sample_anim(time)
        with pass_scope("pre_physics"):
            pose = pose_mod.pre_physics_posing(static, anim_rot, anim_trans,
                                               rates)
        physics = state.physics
        if self.motion is not None and cfg.physics.enabled \
                and self.phys_static.n_bodies:
            with pass_scope("physics"):
                physics, pose = phys_mod.physics_react(
                    static, self.phys_static, physics, pose, cfg.physics)
        with pass_scope("post_physics"):
            pose = pose_mod.post_physics_posing(static, pose, anim_rot,
                                                anim_trans, rates)
        with pass_scope("deform"):
            positions, normals = pose_mod.deform(static, pose,
                                                 sdef=cfg.sdef_true)
        return SimState(time=time, physics=physics), pose, positions, normals

    def morphed_extra_uvs(self, pose):
        """[N,E,4] extra-UV channels with the frame's ext-UV morphs applied
        (rest values + pose-rate offsets). The built-in shader samples no
        extra-UV channel — this is the query surface for custom effects;
        gated like the other extended morphs (AppConfig.apply_extended_morphs
        governs whether callers should apply it)."""
        base = jnp.asarray(self.static.extra_uvs)
        if self.static.n_morphs == 0 or not len(self.static.xum_morph):
            return base
        return base + pose_mod.ext_uv_morph_offsets(self.static,
                                                    pose.leaf_rates)

    def step_and_render(self, state: SimState, width=None, height=None,
                        camera_override=None, atlas=None,
                        proj_transform=None, aspect=None):
        """One frame. `camera_override` = (eye_m, target_m, fov_deg) traced
        arrays — the live-camera path (the reference's orbit controller,
        main.cpp:2370-2480, reads input every frame); passing them as
        arguments keeps the jitted program valid across camera motion."""
        state, pose, positions, normals = self.step_pose(state)
        rcfg = self.config.render
        if camera_override is not None:
            import dataclasses
            eye, target, fov = camera_override
            rcfg = dataclasses.replace(
                rcfg, camera_pos=jnp.asarray(eye, jnp.float32),
                camera_target=jnp.asarray(target, jnp.float32),
                camera_fov_deg=jnp.asarray(fov, jnp.float32))
        elif self.camera is not None:
            # VMD camera track (render/camera_anim.py): positions are MMD
            # units -> meters like the vertex path
            import dataclasses

            from ..render.camera_anim import sample_camera
            cam = sample_camera(self.camera, state.time * self.config.fps)
            scale = rcfg.mmd_to_meter
            rcfg = dataclasses.replace(
                rcfg, camera_pos=cam["eye"] * scale,
                camera_target=cam["target"] * scale,
                camera_fov_deg=cam["fov_deg"],
                camera_orthographic=cam["ortho"])
        if self.light is not None:
            # VMD light track: keys lerp linearly; the sampled direction
            # also drives the shadow frustum (all consumers take traced
            # arrays, so animated light never recompiles)
            import dataclasses

            from ..render.camera_anim import sample_light
            li = sample_light(self.light, state.time * self.config.fps)
            rcfg = dataclasses.replace(
                rcfg, light_color=li["color"], light_direction=li["direction"])
        uv_off, part_color = None, None
        if self.config.apply_extended_morphs and self.static.n_morphs:
            if len(self.static.um_morph) and self.part_textures is not None:
                uv_off = pose_mod.uv_morph_offsets(self.static,
                                                   pose.leaf_rates)
            if len(self.static.mm_morph):
                part_color = pose_mod.material_morph_factors(
                    self.static, pose.leaf_rates)
        image = render_frame(self.static, positions, normals,
                             rcfg,
                             part_textures=self.part_textures,
                             cubemap=self.cubemap,
                             width=width, height=height,
                             uv_offsets=uv_off, part_color=part_color,
                             mmd_maps=self.mmd_maps, atlas=atlas,
                             proj_transform=proj_transform, aspect=aspect)
        return state, image

    def jit_step(self, render: bool = True, width=None, height=None,
                 donate: bool = True):
        """Compile the per-frame function once. The texture atlas rides as
        a jit argument (see packed_atlas), not a baked constant."""
        if not render:
            return jax.jit(self.step_pose,
                           donate_argnums=(0,) if donate else ())
        atlas = self.packed_atlas()
        fn = jax.jit(
            partial(self.step_and_render, width=width, height=height),
            donate_argnums=(0,) if donate else ())
        return lambda state: fn(state, atlas=atlas)

    def rollout(self, state: SimState, n_frames: int, render: bool = True,
                width=None, height=None, atlas=None):
        """N frames inside one device program (lax.scan): the offline-render /
        benchmark path — a single dispatch regardless of frame count.

        Returns (state', per_frame_checksum [N]) when render else (state',
        positions_checksum [N]). Checksums keep every frame's full compute
        live without materializing N framebuffers."""

        def body(state, _):
            if render:
                state, image = self.step_and_render(state, width=width,
                                                    height=height,
                                                    atlas=atlas)
                return state, jnp.mean(image)
            state, _, positions, _ = self.step_pose(state)
            return state, jnp.mean(positions)

        return jax.lax.scan(body, state, None, length=n_frames)

    def jit_rollout(self, n_frames: int, render: bool = True, width=None,
                    height=None):
        atlas = self.packed_atlas() if render else None
        fn = jax.jit(partial(self.rollout, n_frames=n_frames, render=render,
                             width=width, height=height),
                     donate_argnums=(0,))
        return lambda state: fn(state, atlas=atlas)
