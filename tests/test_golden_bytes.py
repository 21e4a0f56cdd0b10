"""Byte-level golden fixtures for the PMX/VMD parsers.

Unlike tests/test_formats.py (writer->parser roundtrips), these fixtures are
hand-authored byte streams built field-by-field from the PMX 2.0 / VMD binary
layout as the reference reads it (`reader/pmx_reader_impl.inl:17-449`,
`reader/interprete/pmx_types.inl:17-95`, `reader/vmd_reader_impl.inl:26-62`,
`interprete/vmd_types.inl:17-59`), with every expected value stated literally
in the assertions. The repo's writers are NOT in the loop — deleting
formats/writers.py would leave these tests intact.

Covers: every index size in {1, 2, 4} and both 'none' encodings
(0xFF/0xFFFF/-1), UTF-16LE and UTF-8 strings, all four skinning kinds,
one morph of each kind, display-frame skipping, rigid bodies, 6DOF joints,
and VMD bone/morph/camera records with known 1/127 interpolator bytes.
"""

import struct

import numpy as np
import pytest

from simple_mmd_renderer.formats import pmx as P
from simple_mmd_renderer.formats import vmd as V


def f(*vals):
    return struct.pack(f"<{len(vals)}f", *vals)


def i32(*vals):
    return struct.pack(f"<{len(vals)}i", *vals)


def u8(*vals):
    return struct.pack(f"<{len(vals)}B", *vals)


def u16(*vals):
    return struct.pack(f"<{len(vals)}H", *vals)


def i8(*vals):
    return struct.pack(f"<{len(vals)}b", *vals)


class Enc:
    """Per-file encoding + index-size context."""

    def __init__(self, utf8, vert, tex, mat, bone, morph, rigid):
        self.utf8 = utf8
        self.sizes = dict(vert=vert, tex=tex, mat=mat, bone=bone,
                          morph=morph, rigid=rigid)

    def text(self, s):
        payload = s.encode("utf-8" if self.utf8 else "utf-16-le")
        return i32(len(payload)) + payload

    def idx(self, kind, v):
        size = self.sizes[kind]
        return struct.pack("<" + {1: "B", 2: "H", 4: "i"}[size], v)

    def none(self, kind):
        """The 'no entity' raw encoding for this index size
        (util/dwarf_impl.inl:84-105: u8/u16/i32 -> 255/65535/-1)."""
        size = self.sizes[kind]
        return self.idx(kind, {1: 0xFF, 2: 0xFFFF, 4: -1}[size])


def build_pmx(enc: Enc) -> bytes:
    b = bytearray()
    # header (pmx_reader_impl.inl:21-48): magic, version, flag-block size 8,
    # [encoding(0=utf16le,1=utf8), extra_uv, idx sizes vert/tex/mat/bone/
    #  morph/rigid]
    b += b"PMX " + f(2.0) + u8(8)
    b += u8(1 if enc.utf8 else 0, 1, enc.sizes["vert"], enc.sizes["tex"],
            enc.sizes["mat"], enc.sizes["bone"], enc.sizes["morph"],
            enc.sizes["rigid"])
    b += enc.text("Aモデル") + enc.text("modelA")
    b += enc.text("デスク") + enc.text("d")

    # --- 4 vertices, one per skinning kind (pmx_reader_impl.inl:50-102)
    b += i32(4)
    # v0: BDEF1
    b += f(1.5, -2.25, 0.5,  0.0, 1.0, 0.0,  0.25, 0.75)   # pos, nrm, uv
    b += f(0.1, 0.2, 0.3, 0.4)                             # extra uv 0
    b += i8(P.BDEF1) + enc.idx("bone", 0)
    b += f(1.0)                                            # edge scale
    # v1: BDEF2, second bone is 'none'
    b += f(0, 0, 1,  1, 0, 0,  0.5, 0.5) + f(0, 0, 0, 0)
    b += i8(P.BDEF2) + enc.idx("bone", 1) + enc.none("bone") + f(0.75)
    b += f(0.5)
    # v2: BDEF4
    b += f(2, 2, 2,  0, 0, 1,  1, 0) + f(0, 0, 0, 0)
    b += i8(P.BDEF4)
    b += enc.idx("bone", 0) + enc.idx("bone", 1) + enc.idx("bone", 2)
    b += enc.none("bone")
    b += f(0.1, 0.2, 0.3, 0.4)
    b += f(2.0)
    # v3: SDEF
    b += f(3, 3, 3,  0, -1, 0,  0, 1) + f(0, 0, 0, 0)
    b += i8(P.SDEF) + enc.idx("bone", 0) + enc.idx("bone", 1) + f(0.6)
    b += f(1, 2, 3) + f(4, 5, 6) + f(7, 8, 9)              # C, R0, R1
    b += f(0.0)

    # --- triangles: index COUNT then flat indices (reader:104-110)
    b += i32(6)
    for v in (0, 1, 2, 2, 1, 3):
        b += enc.idx("vert", v)

    # --- textures (reader:112-121)
    b += i32(2) + enc.text("tex/body.png") + enc.text("face.png")

    # --- materials (reader:123-190); n_indices accumulates base_shift
    b += i32(2)
    b += enc.text("体") + enc.text("body")
    b += f(1.0, 0.5, 0.25, 1.0)        # diffuse rgba
    b += f(0.1, 0.2, 0.3) + f(5.0)     # specular rgb, shininess
    b += f(0.4, 0.5, 0.6)              # ambient
    b += u8(0x1F)                      # all 5 draw flags
    b += f(1.0, 0.0, 0.0, 0.5) + f(1.5)  # edge color, edge size
    b += enc.idx("tex", 0) + enc.none("tex")
    b += u8(2)                         # sub texture type SPA
    b += u8(1) + u8(3)                 # global toon -> 1-byte toon index
    b += enc.text("m")
    b += i32(3)                        # 3 indices = 1 triangle
    b += enc.text("顔") + enc.text("face")
    b += f(1, 1, 1, 1) + f(0, 0, 0) + f(1.0) + f(0, 0, 0)
    b += u8(0x01)
    b += f(0, 0, 0, 1) + f(0.0)
    b += enc.idx("tex", 1) + enc.none("tex")
    b += u8(0)
    b += u8(0) + enc.none("tex")       # model-local toon, none
    b += enc.text("")
    b += i32(3)

    # --- bones (reader:192-264)
    b += i32(3)
    base_flags = (P.BONE_ROTATABLE | P.BONE_MOVABLE | P.BONE_VISIBLE
                  | P.BONE_CONTROLLABLE)
    # b0: root, child offset form
    b += enc.text("センター") + enc.text("center")
    b += f(0, 1, 0) + enc.none("bone") + i32(0)
    b += u16(base_flags)
    b += f(0, 1, 0)                    # child offset (no CHILD_USE_ID)
    # b1: child-by-id + append rotate
    b += enc.text("腕") + enc.text("arm")
    b += f(0, 10, 0) + enc.idx("bone", 0) + i32(0)
    b += u16(base_flags | P.BONE_CHILD_USE_ID | P.BONE_APPEND_ROTATE)
    b += enc.idx("bone", 2)            # child index
    b += enc.idx("bone", 0) + f(0.5)   # append parent + ratio
    # b2: IK + fixed axis + local axis + receive transform
    b += enc.text("足ＩＫ") + enc.text("leg_ik")
    b += f(0, 0, 5) + enc.idx("bone", 1) + i32(1)
    b += u16(base_flags | P.BONE_HAS_IK | P.BONE_ROT_AXIS_FIXED
             | P.BONE_USE_LOCAL_AXIS | P.BONE_RECEIVE_TRANSFORM)
    b += f(0, 2, 0)                    # child offset
    b += f(0, 0, 1)                    # fixed axis
    b += f(1, 0, 0) + f(0, 0, 1)       # local x, local z
    b += i32(7)                        # export key
    b += enc.idx("bone", 0) + i32(40) + f(2.0)   # ik target, loop, angle
    b += i32(2)                        # 2 links
    b += enc.idx("bone", 1) + i8(1) + f(-3.14, 0, 0) + f(0, 0, 0)
    b += enc.idx("bone", 0) + i8(0)

    # --- morphs: one of each kind (reader:266-357)
    b += i32(6)
    b += enc.text("グ") + enc.text("g") + u8(4, P.MORPH_GROUP) + i32(1)
    b += enc.idx("morph", 1) + f(0.5)
    b += enc.text("バ") + enc.text("v") + u8(2, P.MORPH_VERTEX) + i32(2)
    b += enc.idx("vert", 0) + f(0.1, 0.2, 0.3)
    b += enc.idx("vert", 3) + f(-1, 0, 1)
    b += enc.text("ボ") + enc.text("b") + u8(0, P.MORPH_BONE) + i32(1)
    b += enc.idx("bone", 1) + f(1, 2, 3) + f(0, 0, 0.7071, 0.7071)
    b += enc.text("ウ") + enc.text("u") + u8(3, P.MORPH_UV) + i32(1)
    b += enc.idx("vert", 1) + f(0.5, -0.5, 0, 0)
    b += enc.text("エ") + enc.text("e") + u8(3, P.MORPH_EXT_UV_1) + i32(1)
    b += enc.idx("vert", 2) + f(1, 2, 3, 4)
    b += enc.text("マ") + enc.text("m") + u8(1, P.MORPH_MATERIAL) + i32(1)
    b += enc.none("mat") + u8(1) + f(*[float(k) for k in range(28)])

    # --- display frames: parsed and discarded (reader:363-382)
    b += i32(1)
    b += enc.text("表示枠") + enc.text("frame") + u8(1)
    b += i32(2)
    b += u8(0) + enc.idx("bone", 0)    # bone element
    b += u8(1) + enc.idx("morph", 1)   # morph element

    # --- rigid bodies (reader:384-408)
    b += i32(2)
    b += enc.text("髪") + enc.text("hair")
    b += enc.idx("bone", 1)
    b += u8(3) + u16(0xFFF5) + u8(P.SHAPE_CAPSULE)
    b += f(0.3, 1.2, 0) + f(0, 9, 0) + f(0.1, 0.2, 0.3)
    b += f(0.8, 0.2, 0.4, 0.25, 0.7)   # mass, damps, restitution, friction
    b += u8(P.RIGID_PHYSICS)
    b += enc.text("土台") + enc.text("base")
    b += enc.none("bone")
    b += u8(0) + u16(0x0001) + u8(P.SHAPE_SPHERE)
    b += f(2, 0, 0) + f(0, 0, 0) + f(0, 0, 0)
    b += f(0, 0, 0, 0, 0.5)
    b += u8(P.RIGID_KINEMATIC)

    # --- 6DOF spring constraints (reader:410-440)
    b += i32(1)
    b += enc.text("髪J") + enc.text("jn") + u8(0)
    b += enc.idx("rigid", 0) + enc.idx("rigid", 1)
    b += f(0, 8.5, 0) + f(0, 0, 0.5)
    b += f(-1, -2, -3) + f(1, 2, 3)
    b += f(-0.1, -0.2, -0.3) + f(0.1, 0.2, 0.3)
    b += f(10, 20, 30) + f(40, 50, 60)
    return bytes(b)


ENCODINGS = [
    Enc(utf8=False, vert=1, tex=1, mat=1, bone=2, morph=1, rigid=1),
    Enc(utf8=True, vert=2, tex=1, mat=1, bone=1, morph=2, rigid=2),
    Enc(utf8=False, vert=4, tex=4, mat=4, bone=4, morph=4, rigid=4),
]


@pytest.fixture(params=[False, True], ids=["native", "python"])
def parse(request, monkeypatch):
    """Parse via the default (native if available) and the pure-python path."""
    if request.param:
        import simple_mmd_renderer.native as native

        def no_native():
            raise RuntimeError("native disabled for test")
        monkeypatch.setattr(native, "get_lib", no_native)
    return P.parse_pmx


@pytest.mark.parametrize("enc", ENCODINGS,
                         ids=["u16le-sz1", "utf8-sz2", "u16le-sz4"])
def test_pmx_golden_bytes(enc, parse):
    m = parse(build_pmx(enc))

    assert m.name == "Aモデル" and m.name_en == "modelA"
    assert m.description == "デスク" and m.description_en == "d"
    assert m.extra_uv_count == 1

    # vertices
    np.testing.assert_allclose(m.positions[0], [1.5, -2.25, 0.5])
    np.testing.assert_allclose(m.normals[0], [0, 1, 0])
    np.testing.assert_allclose(m.uvs[0], [0.25, 0.75])
    np.testing.assert_allclose(m.extra_uvs[0, 0], [0.1, 0.2, 0.3, 0.4])
    assert m.skin_type.tolist() == [P.BDEF1, P.BDEF2, P.BDEF4, P.SDEF]
    assert m.skin_bones[0, 0] == 0 and m.skin_weights[0, 0] == 1.0
    assert m.skin_bones[1].tolist()[:2] == [1, -1]
    np.testing.assert_allclose(m.skin_weights[1, :2], [0.75, 0.25])
    assert m.skin_bones[2].tolist() == [0, 1, 2, -1]
    np.testing.assert_allclose(m.skin_weights[2], [0.1, 0.2, 0.3, 0.4])
    assert m.skin_bones[3].tolist()[:2] == [0, 1]
    np.testing.assert_allclose(m.skin_weights[3, :2], [0.6, 0.4])
    np.testing.assert_allclose(m.sdef_c[3], [1, 2, 3])
    np.testing.assert_allclose(m.sdef_r0[3], [4, 5, 6])
    np.testing.assert_allclose(m.sdef_r1[3], [7, 8, 9])
    np.testing.assert_allclose(m.edge_scale, [1.0, 0.5, 2.0, 0.0])

    assert m.triangles.tolist() == [[0, 1, 2], [2, 1, 3]]
    assert m.textures == ["tex/body.png", "face.png"]

    # materials + accumulated base_shift (reader:185-189)
    m0, m1 = m.materials
    assert m0.name == "体" and m0.name_en == "body"
    np.testing.assert_allclose(m0.diffuse, [1.0, 0.5, 0.25, 1.0])
    np.testing.assert_allclose(m0.specular, [0.1, 0.2, 0.3])
    assert m0.shininess == 5.0
    np.testing.assert_allclose(m0.ambient, [0.4, 0.5, 0.6])
    assert m0.draw_flags == 0x1F
    np.testing.assert_allclose(m0.edge_color, [1, 0, 0, 0.5])
    assert m0.edge_size == 1.5
    assert m0.texture == 0 and m0.sub_texture == P.NONE
    assert m0.sub_texture_type == 2
    assert m0.toon_is_global and m0.toon == 3
    assert m0.n_triangles == 1 and m0.base_shift == 0
    assert m1.texture == 1 and m1.toon == P.NONE and not m1.toon_is_global
    assert m1.n_triangles == 1 and m1.base_shift == 1

    # bones
    b0, b1, b2 = m.bones
    assert b0.name == "センター" and b0.parent == P.NONE
    assert b0.transform_level == 0
    np.testing.assert_allclose(b0.position, [0, 1, 0])
    np.testing.assert_allclose(b0.child_offset, [0, 1, 0])
    assert b1.parent == 0 and b1.child_index == 2
    assert b1.has(P.BONE_APPEND_ROTATE)
    assert b1.append_parent == 0 and b1.append_ratio == 0.5
    assert b2.parent == 1 and b2.transform_level == 1
    np.testing.assert_allclose(b2.fixed_axis, [0, 0, 1])
    np.testing.assert_allclose(b2.local_x, [1, 0, 0])
    np.testing.assert_allclose(b2.local_z, [0, 0, 1])
    assert b2.export_key == 7
    assert b2.ik_target == 0 and b2.ik_loop == 40
    assert abs(b2.ik_angle - 2.0) < 1e-7
    assert len(b2.ik_links) == 2
    assert b2.ik_links[0].bone == 1 and b2.ik_links[0].has_limit
    np.testing.assert_allclose(b2.ik_links[0].lo, [-3.14, 0, 0])
    assert b2.ik_links[1].bone == 0 and not b2.ik_links[1].has_limit

    # morphs: one of each kind
    g, v, bm, uv, ext, mat = m.morphs
    assert g.type == P.MORPH_GROUP and g.category == 4
    assert g.group_indices.tolist() == [1]
    np.testing.assert_allclose(g.group_rates, [0.5])
    assert v.type == P.MORPH_VERTEX
    assert v.vertex_indices.tolist() == [0, 3]
    np.testing.assert_allclose(v.vertex_offsets[1], [-1, 0, 1])
    assert bm.type == P.MORPH_BONE and bm.bone_indices.tolist() == [1]
    np.testing.assert_allclose(bm.bone_translations[0], [1, 2, 3])
    np.testing.assert_allclose(bm.bone_rotations[0],
                               [0, 0, 0.7071, 0.7071], rtol=1e-6)
    assert uv.type == P.MORPH_UV and uv.uv_vertex_indices.tolist() == [1]
    np.testing.assert_allclose(uv.uv_offsets[0], [0.5, -0.5, 0, 0])
    assert ext.type == P.MORPH_EXT_UV_1
    assert ext.uv_vertex_indices.tolist() == [2]
    np.testing.assert_allclose(ext.uv_offsets[0], [1, 2, 3, 4])
    assert mat.type == P.MORPH_MATERIAL
    assert mat.material_indices.tolist() == [P.NONE]
    assert mat.material_methods.tolist() == [1]
    np.testing.assert_allclose(mat.material_payload[0],
                               np.arange(28, dtype=np.float32))

    # rigid bodies
    r0, r1 = m.rigid_bodies
    assert r0.name == "髪" and r0.bone == 1
    assert r0.group == 3 and r0.mask == 0xFFF5
    assert r0.shape == P.SHAPE_CAPSULE
    np.testing.assert_allclose(r0.dimensions, [0.3, 1.2, 0])
    np.testing.assert_allclose(r0.position, [0, 9, 0])
    np.testing.assert_allclose(r0.rotation, [0.1, 0.2, 0.3], rtol=1e-6)
    assert abs(r0.mass - 0.8) < 1e-7
    assert abs(r0.linear_damping - 0.2) < 1e-7
    assert abs(r0.angular_damping - 0.4) < 1e-7
    assert abs(r0.restitution - 0.25) < 1e-7
    assert abs(r0.friction - 0.7) < 1e-7
    assert r0.type == P.RIGID_PHYSICS
    assert r1.bone == P.NONE and r1.type == P.RIGID_KINEMATIC

    # constraints
    c, = m.constraints
    assert c.body_a == 0 and c.body_b == 1
    np.testing.assert_allclose(c.position, [0, 8.5, 0])
    np.testing.assert_allclose(c.rotation, [0, 0, 0.5])
    np.testing.assert_allclose(c.pos_lo, [-1, -2, -3])
    np.testing.assert_allclose(c.pos_hi, [1, 2, 3])
    np.testing.assert_allclose(c.rot_lo, [-0.1, -0.2, -0.3], rtol=1e-6)
    np.testing.assert_allclose(c.rot_hi, [0.1, 0.2, 0.3], rtol=1e-6)
    np.testing.assert_allclose(c.spring_translate, [10, 20, 30])
    np.testing.assert_allclose(c.spring_rotate, [40, 50, 60])


def _sjis(name, width):
    raw = name.encode("cp932")
    return raw + b"\x00" * (width - len(raw))


def build_vmd() -> bytes:
    b = bytearray()
    # header: 30-byte magic field, 20-byte name (vmd_types.inl:17-19)
    b += b"Vocaloid Motion Data 0002" + b"\x00" * 5
    b += _sjis("テスト", 20)
    # 2 bone keyframes for 右腕 (vmd_bone: name[15], u32 frame, 3f, 4f,
    # 4 x 16-byte interpolators; control points at offsets 0/4/8/12)
    b += struct.pack("<I", 2)
    interp_default = bytearray(16)
    interp_default[0], interp_default[4] = 20, 20       # c0 = (20, 20)/127
    interp_default[8], interp_default[12] = 107, 107    # c1 = (107, 107)/127
    interp_custom = bytearray(16)
    interp_custom[0], interp_custom[4] = 10, 30
    interp_custom[8], interp_custom[12] = 90, 120
    # noise at non-control offsets must be ignored
    for off in (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15):
        interp_custom[off] = 55

    b += _sjis("右腕", 15) + struct.pack("<I", 0)
    b += f(1, 2, 3) + f(0, 0, 0, 1)
    b += bytes(interp_custom) + bytes(interp_default) * 3
    b += _sjis("右腕", 15) + struct.pack("<I", 30)
    b += f(4, 5, 6) + f(0, 0.6, 0, 0.8)
    b += bytes(interp_default) * 4
    # 1 morph keyframe (vmd_morph: name[15], u32 frame, f32 weight)
    b += struct.pack("<I", 1)
    b += _sjis("笑い", 15) + struct.pack("<I", 15) + f(0.75)
    # 1 camera keyframe (vmd_camera: u32 frame, f32 focal, 3f pos, 3f rot,
    # 24 interp bytes, f32 fov, u8 ortho)
    b += struct.pack("<I", 1)
    b += struct.pack("<I", 10) + f(-45.0)
    b += f(0, 10, 0) + f(0.1, 0.2, 0.3)
    b += bytes(range(24))
    b += f(30.0) + u8(1)
    return bytes(b)


def test_vmd_golden_bytes():
    mo = V.parse_vmd(build_vmd())
    assert mo.name == "テスト"

    t = mo.bone_tracks["右腕"]
    assert t.frames.tolist() == [0, 30]
    np.testing.assert_allclose(t.translations, [[1, 2, 3], [4, 5, 6]])
    np.testing.assert_allclose(t.rotations[1], [0, 0.6, 0, 0.8])
    # channel X of key 0 carries the custom curve; offsets 0/4/8/12 only
    np.testing.assert_allclose(t.c0[0, 0], [10 / 127, 30 / 127], rtol=1e-6)
    np.testing.assert_allclose(t.c1[0, 0], [90 / 127, 120 / 127], rtol=1e-6)
    # channels Y/Z/R of key 0 and all of key 1: MMD default (20,20,107,107)
    np.testing.assert_allclose(t.c0[0, 1:], [[20 / 127, 20 / 127]] * 3,
                               rtol=1e-6)
    np.testing.assert_allclose(t.c1[1], [[107 / 127, 107 / 127]] * 4,
                               rtol=1e-6)

    mt = mo.morph_tracks["笑い"]
    assert mt.frames.tolist() == [15]
    np.testing.assert_allclose(mt.weights, [0.75])

    cam = mo.camera
    assert cam.frames.tolist() == [10]
    np.testing.assert_allclose(cam.focal_lengths, [-45.0])
    np.testing.assert_allclose(cam.positions[0], [0, 10, 0])
    np.testing.assert_allclose(cam.rotations[0], [0.1, 0.2, 0.3], rtol=1e-6)
    assert cam.interp[0].tolist() == list(range(24))
    np.testing.assert_allclose(cam.fovs, [30.0])
    assert bool(cam.orthographic[0])


def test_vmd_camera_default_interp_is_linear():
    """MMD's default camera curve bytes (20,107,20,107) per channel are
    (c0.x, c1.x, c0.y, c1.y) — they must presample to the identity ramp."""
    from simple_mmd_renderer.formats.vmd import CameraTrack
    from simple_mmd_renderer.render.camera_anim import bind_camera
    from simple_mmd_renderer.utils.bezier import LINEAR_LUT

    interp = np.tile(np.asarray([20, 107, 20, 107], np.int8), (2, 6))
    track = CameraTrack(
        frames=np.array([0, 30], np.int64),
        focal_lengths=np.array([-40.0, -40.0], np.float32),
        positions=np.zeros((2, 3), np.float32),
        rotations=np.zeros((2, 3), np.float32),
        fovs=np.array([30.0, 30.0], np.float32),
        orthographic=np.zeros(2, bool),
        interp=interp)
    cam = bind_camera(track)
    np.testing.assert_allclose(np.asarray(cam.luts),
                               np.broadcast_to(LINEAR_LUT, (2, 6, 32)),
                               atol=1e-7)
