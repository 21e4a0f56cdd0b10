import numpy as np
import jax.numpy as jnp

from simple_mmd_renderer.core import anim as A
from simple_mmd_renderer.core import model as M
from simple_mmd_renderer.formats import vmd as V
from simple_mmd_renderer.formats.writers import write_vmd
from simple_mmd_renderer.utils import bezier

from fixtures import two_bone_arm


def _oracle_sample(track: V.BoneTrack, frame: float):
    """Direct port of GetBonePose bracket semantics (motion_impl.inl:255-320)."""
    frames = track.frames
    if frames[0] >= frame:
        return track.translations[0], track.rotations[0]
    if frames[-1] <= frame:
        return track.translations[-1], track.rotations[-1]
    right = int(np.searchsorted(frames, np.floor(frame), side="right"))
    left = right - 1
    if frames[left] == frame:
        return track.translations[left], track.rotations[left]
    bary = (frame - frames[left]) / (frames[right] - frames[left])
    luts, _ = bezier.presample(track.c0[left], track.c1[left])  # [4,32]
    lam = np.empty(4, np.float32)
    for c in range(4):
        x = np.float32(bary) * 31
        ix = int(x)
        r = x - ix
        lam[c] = (luts[c][ix] * (1 - r) + luts[c][min(ix + 1, 31)] * r
                  if ix < 31 else luts[c][31])
    tl, tr = track.translations[left], track.translations[right]
    trans = tl * (1 - lam[:3]) + tr * lam[:3]
    a, b = track.rotations[left], track.rotations[right]
    l = lam[3]
    if l < 1e-8:
        rot = a
    elif l > 1 - 1e-8:
        rot = b
    else:
        if np.dot(a, b) < 0:
            raw = (1 - l) * a - l * b
        else:
            raw = (1 - l) * a + l * b
        rot = raw / np.linalg.norm(raw)
    return trans, rot


def _build():
    pm = two_bone_arm()
    static = M.build_model(pm)
    ease = np.array([[5, 80, 30, 120]] * 4, np.int8)
    lin = np.array([[20, 20, 107, 107]] * 4, np.int8)
    data = write_vmd(
        "t",
        bone_keys=[
            ("センター", 0, np.zeros(3), np.array([0, 0, 0, 1.0]), lin),
            ("センター", 20, np.array([1, 2, 3.0]),
             np.array([0, np.sin(0.6), 0, np.cos(0.6)]), ease),
            ("センター", 50, np.array([-1, 0, 1.0]),
             np.array([np.sin(0.5), 0, 0, np.cos(0.5)]), lin),
            ("腕", 10, np.array([0, 1, 0.0]),
             np.array([0, 0, np.sin(0.3), np.cos(0.3)]), ease),
            ("ghost", 5, np.zeros(3), np.array([0, 0, 0, 1.0]), lin),
        ],
        morph_keys=[("にっこり", 0, 0.0), ("にっこり", 30, 1.0),
                    ("曲げ", 10, 0.5)],
    )
    motion = V.parse_vmd(data)
    return static, motion, A.bind_motion(static, motion)


def test_binding_intersects_names():
    static, motion, mo = _build()
    # "ghost" isn't a model bone: 2 bound tracks
    assert mo.b_bone.shape[0] == 2
    assert mo.n_bones == static.n_bones
    assert mo.length == 50


def test_sampling_matches_oracle_across_frames():
    static, motion, mo = _build()
    name_to_track = {"センター": 0, "腕": 1}
    for frame in [0, 1, 5, 10, 15, 20, 27, 35, 49, 50, 60]:
        rot, trans = A.sample_bones(mo, frame)
        for name, bone in (("センター", 0), ("腕", 1)):
            et, er = _oracle_sample(motion.bone_tracks[name], frame)
            np.testing.assert_allclose(trans[bone], et, atol=1e-5,
                                       err_msg=f"{name}@{frame}")
            np.testing.assert_allclose(rot[bone], er, atol=1e-5,
                                       err_msg=f"{name}@{frame}")


def test_fractional_frame_sampling():
    static, motion, mo = _build()
    for frame in [0.5, 10.25, 19.75, 33.3]:
        rot, trans = A.sample_bones(mo, frame)
        et, er = _oracle_sample(motion.bone_tracks["センター"], frame)
        np.testing.assert_allclose(trans[0], et, atol=1e-5)
        np.testing.assert_allclose(rot[0], er, atol=1e-5)


def test_morph_sampling():
    static, motion, mo = _build()
    rates = A.sample_morphs(mo, 15)
    assert rates.shape == (static.n_morphs,)
    np.testing.assert_allclose(rates[0], 0.5, atol=1e-6)  # linear 0->1 over 30
    np.testing.assert_allclose(rates[1], 0.5, atol=1e-6)  # clamped after last
    np.testing.assert_allclose(rates[2], 0.0, atol=1e-6)  # group morph unbound
    rates = A.sample_morphs(mo, 0)
    np.testing.assert_allclose(rates[0], 0.0, atol=1e-6)


def test_unbound_bones_stay_identity():
    static, motion, mo = _build()
    rot, trans = A.sample_bones(mo, 25)
    # bone 1 = "腕" is bound; nothing else beyond 0/1 exists here, but the
    # defaults path is exercised via a motion with zero tracks:
    empty = A.bind_motion(static, V.VmdMotion(name="e"))
    r0, t0 = A.sample_bones(empty, 3)
    np.testing.assert_array_equal(np.asarray(t0), 0)
    np.testing.assert_allclose(np.asarray(r0)[:, 3], 1.0)
