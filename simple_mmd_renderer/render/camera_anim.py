"""VMD camera-track animation.

The reference parses camera keyframes (`reader/vmd_reader_impl.inl:81-108`)
but leaves pose sampling unimplemented (`scene/camera_impl.inl:74-75` is
commented out). We implement the full standard MMD camera semantics the data
encodes:

- `position` is the look-at target (MMD units), `focal_length` the (negative)
  orbit distance, `rotation` YXZ-ish euler angles of the orbit,
  `fov` the vertical field of view in degrees, plus per-channel Bezier easing
  (interp bytes: 6 channels x 4 control bytes: x,y,z,rot,dist,fov).

`bind_camera` packs the track into device arrays; `sample_camera` returns the
interpolated (eye, target, fov_deg) — feed into render.camera.look_at /
perspective. Positions are converted to meters by the caller's unit scale.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..formats.vmd import CameraTrack
from ..utils import bezier
from ..utils import pytree
from ..utils import math3d as m3


@pytree.dataclass
class CameraArrays:
    frames: jnp.ndarray     # [K] f32
    targets: jnp.ndarray    # [K,3]
    rotations: jnp.ndarray  # [K,3] euler
    distances: jnp.ndarray  # [K]
    fovs: jnp.ndarray       # [K]
    ortho: jnp.ndarray      # [K] f32 (0/1)
    luts: jnp.ndarray       # [K,6,32] easing (x,y,z,rot,dist,fov)


def bind_camera(track: CameraTrack) -> CameraArrays:
    k = len(track.frames)
    interp = track.interp.astype(np.float32).reshape(k, 24) / 127.0
    # channel c control points at bytes [c*4 .. c*4+3] = (c0.x, c1.x, c0.y,
    # c1.y) — the per-channel byte order of the VMD camera section (MMD's
    # default curve is bytes (20, 107, 20, 107), i.e. c0=(20,20) c1=(107,107),
    # which must presample to the linear identity ramp)
    c = interp.reshape(k, 6, 4)
    lut, _ = bezier.presample(c[..., [0, 2]], c[..., [1, 3]])  # [K,6,32]
    return CameraArrays(
        frames=jnp.asarray(track.frames, jnp.float32),
        targets=jnp.asarray(track.positions),
        rotations=jnp.asarray(track.rotations),
        distances=jnp.asarray(track.focal_lengths),
        fovs=jnp.asarray(track.fovs),
        ortho=jnp.asarray(track.orthographic, jnp.float32),
        luts=jnp.asarray(lut))


def sample_camera(cam: CameraArrays, frame):
    """-> dict(eye, target, fov_deg, ortho) at `frame` (MMD units)."""
    frame = jnp.asarray(frame, jnp.float32)
    k = cam.frames.shape[0]
    pos = jnp.searchsorted(cam.frames, jnp.floor(frame), side="right")
    right = jnp.clip(pos, 1, k - 1).astype(jnp.int32)
    left = right - 1
    fl = cam.frames[left]
    fr = cam.frames[right]
    use_left = (cam.frames[0] >= frame) | (cam.frames[k - 1] <= frame) | (
        fl == frame)
    left = jnp.where(cam.frames[0] >= frame, 0, left)
    left = jnp.where(cam.frames[k - 1] <= frame, k - 1, left)
    bary = (frame - fl) / jnp.maximum(fr - fl, 1.0)
    lam = bezier.lut_eval(cam.luts[left], bary[None])  # [6]

    def ch(vals, i):
        lo, hi = vals[left], vals[right]
        out = lo * (1.0 - lam[i]) + hi * lam[i]
        return jnp.where(use_left, lo, out)

    target = jnp.stack([ch(cam.targets[:, 0], 0), ch(cam.targets[:, 1], 1),
                        ch(cam.targets[:, 2], 2)], -1)
    rot = jnp.stack([ch(cam.rotations[:, 0], 3), ch(cam.rotations[:, 1], 3),
                     ch(cam.rotations[:, 2], 3)], -1)
    dist = ch(cam.distances, 4)
    fov = ch(cam.fovs, 5)

    # orbit: eye = target + R(euler_yxz) @ (0, 0, distance); MMD's camera
    # rotation x is pitch (negated), y yaw, z roll
    q = m3.euler_to_quat(rot * jnp.asarray([-1.0, 1.0, 1.0]), "yxz")
    eye = target + m3.quat_rotate(q, jnp.asarray([0.0, 0.0, 1.0]) * dist)
    return dict(eye=eye, target=target, fov_deg=fov,
                ortho=cam.ortho[left] > 0.5)


@pytree.dataclass
class LightArrays:
    """VMD light track packed for device sampling (see formats.vmd.LightTrack
    — the capability the reference's `light_motion_reader.inl` declares but
    never implements). Light keys carry no Bezier bytes; MMD lerps them."""
    frames: jnp.ndarray      # [K] f32
    colors: jnp.ndarray      # [K,3]
    directions: jnp.ndarray  # [K,3]


def bind_light(track) -> LightArrays:
    return LightArrays(
        frames=jnp.asarray(track.frames, jnp.float32),
        colors=jnp.asarray(track.colors, jnp.float32),
        directions=jnp.asarray(track.directions, jnp.float32))


def sample_light(light: LightArrays, frame):
    """-> dict(color [3], direction [3]) linearly interpolated at `frame`."""
    frame = jnp.asarray(frame, jnp.float32)
    k = light.frames.shape[0]
    pos = jnp.searchsorted(light.frames, jnp.floor(frame), side="right")
    right = jnp.clip(pos, 1, k - 1).astype(jnp.int32)
    left = right - 1
    fl, fr = light.frames[left], light.frames[right]
    use_left = (light.frames[0] >= frame) | (light.frames[k - 1] <= frame) | (
        fl == frame)
    left = jnp.where(light.frames[0] >= frame, 0, left)
    left = jnp.where(light.frames[k - 1] <= frame, k - 1, left)
    t = jnp.clip((frame - fl) / jnp.maximum(fr - fl, 1.0), 0.0, 1.0)

    def ch(vals):
        lo, hi = vals[left], vals[right]
        return jnp.where(use_left, lo, lo * (1.0 - t) + hi * t)

    direction = ch(light.directions)
    norm = jnp.linalg.norm(direction)
    direction = jnp.where(norm > 1e-6, direction / jnp.maximum(norm, 1e-6),
                          jnp.asarray([0.0, -1.0, 0.0], jnp.float32))
    return dict(color=ch(light.colors), direction=direction)
