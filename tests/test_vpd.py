"""VPD pose reader tests (formats/vpd.py).

The reference only declares the abstract PoseReader
(`reader/pose_reader.inl:14-17`); these tests pin the concrete VPD
semantics: cp932 text with // comments, Bone blocks (translation;
quaternion;), Morph blocks (weight;), and the single-keyframe VmdMotion
representation that holds the pose at every sampled time.
"""

import os

import numpy as np
import pytest

from simple_mmd_renderer.core import anim as A
from simple_mmd_renderer.core import model as M
from simple_mmd_renderer.formats import vpd as VPD
from simple_mmd_renderer.utils.io import ParseError

from fixtures import two_bone_arm

VPD_TEXT = """Vocaloid Pose Data file

arm.osm;\t\t// 親ファイル名
2;\t\t\t\t// 総ポーズボーン数

Bone0{センター
  0.100000,2.000000,-0.300000;\t\t\t\t// trans x,y,z
  0.000000,0.000000,0.000000,1.000000;\t\t// Quaternion x,y,z,w
}

Bone1{腕
  0.000000,0.000000,0.000000;
  0.382683,0.000000,0.000000,0.923880;\t\t// 45deg about x
}

Morph0{にっこり
  0.750000;
}
"""


def _vpd_bytes(text=VPD_TEXT):
    return text.encode("cp932")


def test_parse_vpd_bones_and_morphs():
    mo = VPD.parse_vpd(_vpd_bytes(), name="p")
    assert set(mo.bone_tracks) == {"センター", "腕"}
    assert set(mo.morph_tracks) == {"にっこり"}
    c = mo.bone_tracks["センター"]
    np.testing.assert_allclose(c.translations, [[0.1, 2.0, -0.3]], atol=1e-6)
    np.testing.assert_allclose(c.rotations, [[0, 0, 0, 1]], atol=1e-6)
    a = mo.bone_tracks["腕"]
    np.testing.assert_allclose(a.rotations[0, 0], 0.382683, atol=1e-6)
    assert mo.morph_tracks["にっこり"].weights[0] == pytest.approx(0.75)
    assert mo.length == 0  # single keyframe at frame 0


def test_vpd_parse_errors():
    with pytest.raises(ParseError):
        VPD.parse_vpd(b"not a pose file\n")
    with pytest.raises(ParseError):  # no blocks
        VPD.parse_vpd("Vocaloid Pose Data file\n\nx.osm;\n0;\n".encode())
    bad = VPD_TEXT.replace("0.100000,2.000000,-0.300000", "0.1,2.0")
    with pytest.raises(ParseError):  # 2 values where 3 expected
        VPD.parse_vpd(_vpd_bytes(bad))
    bad = VPD_TEXT.replace("0.750000", "zero.75")
    with pytest.raises(ParseError):
        VPD.parse_vpd(_vpd_bytes(bad))


def test_vpd_pose_holds_at_every_time():
    """Bound through the normal bind_motion pipeline, the single key
    clamps: the pose is identical at frame 0 and frame 1000."""
    static = M.build_model(two_bone_arm())
    mo = A.bind_motion(static, VPD.parse_vpd(_vpd_bytes()))
    for frame in (0.0, 7.5, 1000.0):
        rot, trans = A.sample_bones(mo, frame)
        np.testing.assert_allclose(trans[0], [0.1, 2.0, -0.3], atol=1e-6)
        np.testing.assert_allclose(rot[1], [0.382683, 0, 0, 0.923880],
                                   atol=1e-6)
        rates = A.sample_morphs(mo, frame)
        assert np.max(rates) == pytest.approx(0.75)


def test_load_vpd_cli_end_to_end(tmp_path):
    """--pose holds a VPD through the CLI (here: merged over the sample
    motion, filling tracks the motion does not key)."""
    from simple_mmd_renderer.app import cli

    p = os.path.join(tmp_path, "pose.vpd")
    with open(p, "wb") as f:
        f.write(_vpd_bytes())
    out = os.path.join(tmp_path, "f")
    rc = cli.main(["--sample", "--frames", "2", "--width", "64",
                   "--height", "48", "--shadow-size", "32",
                   "--density", "0.3", "--pose", p, "--out", out])
    assert rc == 0
    assert os.path.isfile(os.path.join(out, "frame_00001.png"))
