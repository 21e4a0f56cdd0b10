"""Motion binding + keyframe sampling.

Rebuild of libmmd's `Motion::GetBonePose/GetMorphPose`
(`motion/motion_impl.inl:255-465`) and `MotionPlayer` name binding
(`poser_impl.inl:522-555`) in array form: every bound track's keyframes are
concatenated into flat arrays sorted by (track, frame); one vectorized
`searchsorted` over a fused int32 key brackets all tracks at once; Bezier
easing uses the 32-sample LUTs presampled at load (utils.bezier).

Clamp semantics match the reference exactly: frame <= first key -> first key,
frame >= last key -> last key, exact hit -> left key, otherwise per-axis
Bezier-eased lerp for translation and Bezier-eased NLerp for rotation.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..formats.vmd import VmdMotion
from ..utils import bezier
from ..utils import pytree
from ..utils import math3d as m3
from .model import ModelStatic

_FRAME_BITS = 18
_FRAME_SPAN = 1 << _FRAME_BITS  # supports motions up to ~2.4h at 30fps
_MAX_TRACKS = (1 << 30) // _FRAME_SPAN


@pytree.dataclass
class MotionArrays:
    # bone tracks (K total keys over T tracks)
    b_key: jnp.ndarray     # [K] int32 fused (track << 18 | frame), ascending
    b_frame: jnp.ndarray   # [K] int32
    b_trans: jnp.ndarray   # [K,3] f32
    b_quat: jnp.ndarray    # [K,4] f32
    b_lut: jnp.ndarray     # [K,4,32] f32 easing LUTs (x,y,z,r)
    b_off: jnp.ndarray     # [T+1] int32 track key offsets
    b_bone: jnp.ndarray    # [T] int32 target bone index
    # morph tracks
    m_key: jnp.ndarray     # [Km] int32
    m_frame: jnp.ndarray   # [Km] int32
    m_weight: jnp.ndarray  # [Km] f32
    m_lut: jnp.ndarray     # [Km,32] f32
    m_off: jnp.ndarray     # [Tm+1] int32
    m_morph: jnp.ndarray   # [Tm] int32
    n_bones: int = pytree.field(static=True)
    n_morphs: int = pytree.field(static=True)
    length: int = pytree.field(static=True)


def bind_motion(static: ModelStatic, motion: VmdMotion) -> MotionArrays:
    """Intersect motion track names with model bone/morph names (MotionPlayer
    ctor) and pack device arrays."""
    bone_ids = {}
    for i, name in enumerate(static.bone_names):
        bone_ids.setdefault(name, i)  # first bone wins on duplicate names
    morph_ids = {}
    for i, name in enumerate(static.morph_names):
        morph_ids.setdefault(name, i)

    b_frames, b_trans, b_quat, b_lut, b_bone = [], [], [], [], []
    for name, track in motion.bone_tracks.items():
        if name not in bone_ids or track.frames.size == 0:
            continue
        b_bone.append(bone_ids[name])
        b_frames.append(track.frames.astype(np.int32))
        b_trans.append(track.translations)
        b_quat.append(track.rotations)
        lut, _ = bezier.presample(track.c0, track.c1)  # [K,4,32]
        b_lut.append(lut)

    m_frames, m_weight, m_lut, m_morph = [], [], [], []
    for name, track in motion.morph_tracks.items():
        if name not in morph_ids or track.frames.size == 0:
            continue
        m_morph.append(morph_ids[name])
        m_frames.append(track.frames.astype(np.int32))
        m_weight.append(track.weights)
        lut, _ = bezier.presample(track.c0, track.c1)  # [K,32]
        m_lut.append(lut)

    if len(b_bone) >= _MAX_TRACKS or len(m_morph) >= _MAX_TRACKS:
        raise ValueError("too many motion tracks for fused int32 keys")

    def pack(frames_list, track_count):
        if track_count == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(1, np.int32))
        counts = np.array([len(f) for f in frames_list], np.int32)
        off = np.zeros(track_count + 1, np.int32)
        np.cumsum(counts, out=off[1:])
        frames = np.concatenate(frames_list).astype(np.int32)
        track_of = np.repeat(np.arange(track_count, dtype=np.int32), counts)
        key = (track_of << _FRAME_BITS) | np.minimum(frames, _FRAME_SPAN - 1)
        return key, frames, off

    bk, bf, boff = pack(b_frames, len(b_bone))
    mk, mf, moff = pack(m_frames, len(m_morph))

    # NOTE: leaves stay NumPy — they embed as literal constants in traced
    # programs without a device round trip.
    j = np.asarray
    return MotionArrays(
        b_key=j(bk), b_frame=j(bf),
        b_trans=j(np.concatenate(b_trans) if b_trans else np.zeros((0, 3), np.float32)),
        b_quat=j(np.concatenate(b_quat) if b_quat else np.zeros((0, 4), np.float32)),
        b_lut=j(np.concatenate(b_lut) if b_lut else np.zeros((0, 4, 32), np.float32)),
        b_off=j(boff), b_bone=j(np.asarray(b_bone, np.int32)),
        m_key=j(mk), m_frame=j(mf),
        m_weight=j(np.concatenate(m_weight) if m_weight else np.zeros(0, np.float32)),
        m_lut=j(np.concatenate(m_lut) if m_lut else np.zeros((0, 32), np.float32)),
        m_off=j(moff), m_morph=j(np.asarray(m_morph, np.int32)),
        n_bones=static.n_bones, n_morphs=static.n_morphs,
        length=motion.length,
    )


def _bracket(key, frame_arr, off, frame):
    """For every track: (left_idx, right_idx, use_left_only).

    Replicates the branch ladder in GetBonePose (motion_impl.inl:255-320).
    frame may be float (SeekTime) or int (SeekFrame)."""
    key = jnp.asarray(key)
    frame_arr = jnp.asarray(frame_arr)
    off = jnp.asarray(off)
    t = jnp.arange(off.shape[0] - 1, dtype=jnp.int32)
    k0 = off[:-1]
    kn = off[1:]
    iframe = jnp.asarray(jnp.floor(frame), jnp.int32)
    fused = (t << _FRAME_BITS) | jnp.clip(iframe, 0, _FRAME_SPAN - 1)
    pos = jnp.searchsorted(key, fused, side="right").astype(jnp.int32)

    first_f = frame_arr[k0]
    last_f = frame_arr[jnp.maximum(kn - 1, 0)]
    right = jnp.clip(pos, k0 + 1, kn - 1)
    left = right - 1

    before = first_f.astype(jnp.float32) >= frame
    after = last_f.astype(jnp.float32) <= frame
    exact = frame_arr[left].astype(jnp.float32) == frame

    left = jnp.where(before, k0, jnp.where(after, kn - 1, left))
    use_left = before | after | exact
    return left, right, use_left


def sample_bones(mo: MotionArrays, frame):
    """-> (anim_rot [B,4], anim_trans [B,3]) for all model bones (identity for
    unbound bones), at integer or fractional `frame`."""
    anim_rot = m3.quat_identity((mo.n_bones,))
    anim_trans = jnp.zeros((mo.n_bones, 3), jnp.float32)
    if mo.b_bone.shape[0] == 0:
        return anim_rot, anim_trans

    frame = jnp.asarray(frame, jnp.float32)
    left, right, use_left = _bracket(mo.b_key, mo.b_frame, mo.b_off, frame)

    b_frame = jnp.asarray(mo.b_frame)
    b_trans = jnp.asarray(mo.b_trans)
    b_quat = jnp.asarray(mo.b_quat)
    b_lut = jnp.asarray(mo.b_lut)
    fl = b_frame[left].astype(jnp.float32)
    fr = b_frame[right].astype(jnp.float32)
    bary = (frame - fl) / jnp.maximum(fr - fl, 1.0)

    lut = b_lut[left]                           # [T,4,32]
    lam = bezier.lut_eval(lut, bary[:, None])   # [T,4]

    tl, tr = b_trans[left], b_trans[right]
    trans = tl * (1.0 - lam[:, :3]) + tr * lam[:, :3]
    rot = m3.quat_nlerp(b_quat[left], b_quat[right], lam[:, 3])

    trans = jnp.where(use_left[:, None], tl, trans)
    rot = jnp.where(use_left[:, None], b_quat[left], rot)

    anim_rot = anim_rot.at[jnp.asarray(mo.b_bone)].set(rot)
    anim_trans = anim_trans.at[jnp.asarray(mo.b_bone)].set(trans)
    return anim_rot, anim_trans


def sample_morphs(mo: MotionArrays, frame):
    """-> morph_rates [M] (zero for unbound morphs)."""
    rates = jnp.zeros((mo.n_morphs,), jnp.float32)
    if mo.m_morph.shape[0] == 0:
        return rates
    frame = jnp.asarray(frame, jnp.float32)
    left, right, use_left = _bracket(mo.m_key, mo.m_frame, mo.m_off, frame)
    m_frame = jnp.asarray(mo.m_frame)
    m_weight = jnp.asarray(mo.m_weight)
    fl = m_frame[left].astype(jnp.float32)
    fr = m_frame[right].astype(jnp.float32)
    bary = (frame - fl) / jnp.maximum(fr - fl, 1.0)
    lam = bezier.lut_eval(jnp.asarray(mo.m_lut)[left], bary)
    wl, wr = m_weight[left], m_weight[right]
    w = jnp.where(use_left, wl, wl * (1.0 - lam) + wr * lam)
    return rates.at[jnp.asarray(mo.m_morph)].set(w)


def sample_motion(mo: MotionArrays, frame):
    anim_rot, anim_trans = sample_bones(mo, frame)
    return anim_rot, anim_trans, sample_morphs(mo, frame)
