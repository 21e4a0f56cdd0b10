"""Multi-instance (crowd) execution and device-mesh sharding.

The reference is a single-model desktop app; the accelerator's scaling
dimension (SURVEY.md §2.6) is the *instance batch*: one jitted program steps
and renders many characters. On one device, vmap batches every stage
(skinning, IK, physics, raster); across devices, the instance axis is sharded
over a 1-D `jax.sharding` mesh so XLA keeps all compute local and inserts no
collectives on the hot path (embarrassingly parallel; the interconnect
carries only the final gather of results).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.scene import Scene, SimState


def _shard_map(fn, *, mesh, in_specs, out_specs):
    """jax.shard_map with the varying-manual-axes check off: the fused
    raster's pallas_call has no rule for it."""
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    import numpy as np
    return Mesh(np.asarray(devices), (axis,))


def crowd_init(scene: Scene, n: int, phase_frames: float = 7.0) -> SimState:
    """n instance states with staggered animation clocks (independent-looking
    motion from one motion track)."""
    base = scene.init_state()

    def tile(x):
        return jnp.broadcast_to(x, (n,) + x.shape).copy()

    state = jax.tree.map(tile, base)
    times = jnp.arange(n, dtype=jnp.float32) * (phase_frames / scene.config.fps)
    return state.replace(time=times)


_FALLBACK_NOTICED: set = set()


def _pick_fallback_scan(cfg_r) -> bool:
    from ..render.pipeline import _pick_raster
    from ..render import raster
    return _pick_raster(cfg_r) is raster.rasterize


def crowd_step_fn(scene: Scene, render: bool = True, width=None, height=None,
                  atlas_arg: bool = False):
    """Per-frame crowd function over the instance axis.

    When the config allows it, rendering goes through the FUSED
    multi-instance raster (render.pipeline.crowd_render_frame): one binning
    sort and one kernel launch across all instances, instead of vmapping
    the single-instance pipeline (whose per-instance fixed costs dominate
    at crowd viewport sizes). Textures, native 4x MSAA, edge outlines,
    double-sided materials, the skybox, MMD toon/sphere shading and
    extended morphs (per-instance UV offsets / material factors) are
    fused; what the fused path doesn't cover (per-instance VMD camera,
    the supersample-emulation MSAA) falls back to the vmap."""
    if not render:
        return jax.vmap(scene.step_pose)

    from ..render.pipeline import (crowd_render_frame,
                                   crowd_render_supported)
    st = scene.static
    uses_ext_morphs = bool(
        scene.config.apply_extended_morphs
        and (len(st.um_morph) or len(st.mm_morph)))
    if crowd_render_supported(
            scene.config.render, scene.part_textures, scene.cubemap,
            scene.camera):
        from ..core import pose as pose_mod

        def step(state, atlas=None):
            state, pose, positions, normals = jax.vmap(scene.step_pose)(state)
            # extended morphs (same static gates as Scene.step_and_render):
            # per-instance UV offsets / material factors from the vmapped
            # leaf rates — they ride the fused path's instance axis
            uv_off = part_color = None
            if uses_ext_morphs:
                if len(st.um_morph) and scene.part_textures is not None:
                    uv_off = jax.vmap(
                        lambda lr: pose_mod.uv_morph_offsets(st, lr))(
                            pose.leaf_rates)
                if len(st.mm_morph):
                    part_color = jax.vmap(
                        lambda lr: pose_mod.material_morph_factors(st, lr))(
                            pose.leaf_rates)
            images = crowd_render_frame(scene.static, positions, normals,
                                        scene.config.render, width, height,
                                        part_textures=scene.part_textures,
                                        atlas=atlas, cubemap=scene.cubemap,
                                        mmd_maps=scene.mmd_maps,
                                        uv_offsets=uv_off,
                                        part_color=part_color)
            return state, images
        return step if atlas_arg else (lambda state: step(state))

    # one-line notice (once per process+reason): the vmap fallback pays
    # per-instance fixed costs the fused path does not — users should know
    # which path they're on
    import sys as _sys
    cfg_r = scene.config.render
    reasons = [r for r, on in (
        ("msaa_supersample", bool(cfg_r.msaa >= 4 and cfg_r.msaa_supersample)),
        ("vmd_camera", scene.camera is not None),
        ("scan_raster", _pick_fallback_scan(cfg_r)),
    ) if on]
    key = tuple(reasons)
    if key not in _FALLBACK_NOTICED:
        _FALLBACK_NOTICED.add(key)
        print(f"# crowd: vmap(render_frame) fallback (fused path excluded "
              f"by: {', '.join(reasons) or 'unknown config'})",
              file=_sys.stderr)

    # vmap fallback: disable prefix-compacted binning AND bbox-windowed
    # albedo — both select their static-size branch with lax.switch on a
    # per-instance value, which batches under vmap to an all-branches
    # select (every ladder rung / window size runs for every instance)
    if scene.config.render.compact_bin or scene.config.render.albedo_window:
        import copy
        import dataclasses
        scene = copy.copy(scene)
        scene.config = dataclasses.replace(
            scene.config,
            render=dataclasses.replace(scene.config.render,
                                       compact_bin=False,
                                       albedo_window=False))
    base = partial(scene.step_and_render, width=width, height=height)
    if atlas_arg:
        def step_fb(state, atlas=None):
            return jax.vmap(lambda s: base(s, atlas=atlas))(state)
        return step_fb
    return jax.vmap(base)


def shard_crowd(state: SimState, mesh: Mesh, axis: str = "data") -> SimState:
    """Place a crowd state with the instance axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis))

    def put(x):
        return jax.device_put(x, sharding)

    return jax.tree.map(put, state)


def band_transform(n_bands: int, band_index):
    """Clip-space window transform selecting horizontal band `band_index`
    (0 = top rows) of an `n_bands`-way row split of the full frame.

    Screen rows map linearly to NDC y, so band b's local NDC y' relates to
    the full-frame NDC y by y = (y' + c) / n with c = n - 1 - 2b; the
    inverse y'_clip = n*y_clip - c*w_clip is linear in clip space and
    therefore a plain 4x4 left-multiplied onto the projection matrix.
    `band_index` may be a traced value (e.g. lax.axis_index inside
    shard_map)."""
    i = jnp.asarray(band_index, jnp.float32)
    c = jnp.float32(n_bands - 1) - 2.0 * i
    return (jnp.eye(4, dtype=jnp.float32)
            .at[1, 1].set(float(n_bands)).at[1, 3].set(-c))


def frame_jit(scene: Scene, mesh: Mesh, width=None, height=None,
              axis: str = "data"):
    """Tile-parallel SINGLE-frame rendering: the framebuffer's row axis is
    sharded over the mesh (classic sort-first parallel rasterization, recast
    as SPMD over a jax mesh).

    The crowd path (crowd_jit) scales *instances*; this scales *pixels* —
    one big model at high resolution. Each device replicates the cheap
    geometry stages (anim/IK/physics/deform — identical inputs, identical
    results) and rasterizes + shades only its horizontal band through a
    clip-space window transform (band_transform), so the hot per-pixel work
    splits n_devices ways with NO hot-path collectives: the banded image
    shards ARE the output rows, concatenated by the out_spec.

    The reference has no counterpart (single GPU); this is the answer to
    \"render one heavy scene faster than one device\".

    The downsampled ground-shadow fast path is band-safe since r5: its
    lo-res lit map carries one GEOMETRIC halo row per edge (ground_pass
    row0/rows), so each band's upsample blends the neighbor band's true
    edge rows — banded output equals the single-device fast path. Bands
    whose height the downsample factor doesn't divide fall back to the
    exact per-pixel lookup (documented divergence from the single-device
    fast path, which keys off the FULL height)."""
    import dataclasses

    n = int(mesh.devices.size)
    W = width or scene.config.render.width
    H = height or scene.config.render.height
    assert H % n == 0, f"height {H} must split over {n} devices"
    atlas = scene.packed_atlas()
    ds = max(int(scene.config.render.shadow_lookup_downsample), 1)
    if ds > 1 and ((H // n) % ds or W % ds):
        scene = dataclasses.replace(scene, config=dataclasses.replace(
            scene.config, render=dataclasses.replace(
                scene.config.render, shadow_lookup_downsample=1)))

    # the packed atlas rides jit as an ARGUMENT (replicated), not a
    # closed-over constant — see Scene.packed_atlas
    def fn(state, atl):
        band = band_transform(n, jax.lax.axis_index(axis))
        state, image = scene.step_and_render(
            state, width=W, height=H // n, atlas=atl,
            proj_transform=band, aspect=W / H)
        return state, image

    sharded = _shard_map(fn, mesh=mesh, in_specs=(P(), P()),
                         out_specs=(P(), P(axis)))
    jfn = jax.jit(sharded)
    return lambda state: jfn(state, atlas)


def crowd_jit(scene: Scene, mesh: Mesh, render: bool = True, width=None,
              height=None, axis: str = "data"):
    """jit the crowd step with the instance axis sharded over the mesh via
    shard_map: every stage — including the FUSED multi-instance raster's
    global sort and kernel launch — runs on its device-local instance
    shard, so XLA inserts no collectives on the hot path (the instance
    batch is embarrassingly parallel)."""
    atlas = scene.packed_atlas() if render else None
    if atlas is None:
        fn = crowd_step_fn(scene, render=render, width=width, height=height)
        sharded = _shard_map(fn, mesh=mesh, in_specs=(P(axis),),
                             out_specs=P(axis))
        return jax.jit(sharded)
    # textured: the packed atlas rides jit as an ARGUMENT (replicated over
    # the mesh), not a closed-over constant (see Scene.packed_atlas)
    fn = crowd_step_fn(scene, render=render, width=width, height=height,
                       atlas_arg=True)
    sharded = _shard_map(fn, mesh=mesh, in_specs=(P(axis), P()),
                         out_specs=P(axis))
    jfn = jax.jit(sharded)
    return lambda state: jfn(state, atlas)
