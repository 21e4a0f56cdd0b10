"""Synthetic PMX/VMD fixtures (the reference repo ships no small test assets)."""

import numpy as np

from simple_mmd_renderer.formats import pmx as P


def _mat(name, n_tris, base, tex=-1):
    return P.Material(
        name=name, name_en=name, diffuse=np.array([1, 1, 1, 1], np.float32),
        specular=np.array([0.3, 0.3, 0.3], np.float32), shininess=8.0,
        ambient=np.array([0.5, 0.5, 0.5], np.float32), draw_flags=P.MAT_DOUBLE_FACE,
        edge_color=np.array([0, 0, 0, 1], np.float32), edge_size=1.0,
        texture=tex, sub_texture=-1, sub_texture_type=0,
        toon_is_global=True, toon=0, meta="", n_triangles=n_tris, base_shift=base)


def two_bone_arm() -> P.PmxModel:
    """Root + child bone, 4 vertices covering BDEF1/BDEF2/BDEF4/SDEF, one
    vertex morph + bone morph + group morph, a quad of 2 triangles."""
    m = P.PmxModel()
    m.name, m.name_en = "arm", "arm"
    m.description = m.description_en = "synthetic"
    m.extra_uv_count = 0

    m.positions = np.array(
        [[0, 0, 0], [1, 0, 0], [2, 0, 0], [1, 1, 0]], np.float32)
    m.normals = np.tile(np.array([[0, 0, -1]], np.float32), (4, 1))
    m.uvs = np.array([[0, 0], [0.5, 0], [1, 0], [0.5, 1]], np.float32)
    m.extra_uvs = np.zeros((4, 0, 4), np.float32)
    m.skin_type = np.array([P.BDEF1, P.BDEF2, P.BDEF4, P.SDEF], np.uint8)
    m.skin_bones = np.array(
        [[0, -1, -1, -1], [0, 1, -1, -1], [0, 1, 0, 1], [0, 1, -1, -1]], np.int32)
    m.skin_weights = np.array(
        [[1, 0, 0, 0], [0.25, 0.75, 0, 0], [0.1, 0.2, 0.3, 0.4], [0.5, 0.5, 0, 0]],
        np.float32)
    m.sdef_c = np.zeros((4, 3), np.float32)
    m.sdef_r0 = np.zeros((4, 3), np.float32)
    m.sdef_r1 = np.zeros((4, 3), np.float32)
    m.sdef_c[3] = [1, 0, 0]
    m.edge_scale = np.ones(4, np.float32)
    m.triangles = np.array([[0, 1, 3], [1, 2, 3]], np.int32)
    m.textures = ["tex/body.png"]
    m.materials = [_mat("skin", 2, 0, tex=0)]

    root = P.Bone("センター", "center", np.zeros(3, np.float32), P.NONE, 0,
                  P.BONE_ROTATABLE | P.BONE_MOVABLE | P.BONE_VISIBLE)
    root.child_offset = np.array([1, 0, 0], np.float32)
    child = P.Bone("腕", "arm", np.array([1, 0, 0], np.float32), 0, 0,
                   P.BONE_ROTATABLE | P.BONE_VISIBLE)
    child.child_offset = np.array([1, 0, 0], np.float32)
    m.bones = [root, child]

    m.morphs = [
        P.Morph("にっこり", "smile", 4, P.MORPH_VERTEX,
                vertex_indices=np.array([3], np.int32),
                vertex_offsets=np.array([[0, 0.5, 0]], np.float32)),
        P.Morph("曲げ", "bend", 4, P.MORPH_BONE,
                bone_indices=np.array([1], np.int32),
                bone_translations=np.array([[0, 0.2, 0]], np.float32),
                bone_rotations=np.array([[0, 0, 0.3826834, 0.9238795]], np.float32)),
        P.Morph("グループ", "group", 4, P.MORPH_GROUP,
                group_indices=np.array([0], np.int32),
                group_rates=np.array([0.5], np.float32)),
    ]
    return m


def ik_leg() -> P.PmxModel:
    """3-link planar chain + IK bone, mirroring an MMD leg rig.

    bones: 0 root(0,0,0) -> 1 hip(0,4,0) -> 2 knee(0,2,0) -> 3 ankle(0,0,0)
           4 ik bone (movable, has IK targeting ankle via links [knee, hip])
    Positions use MMD-style y-down-leg layout.
    """
    m = P.PmxModel()
    m.name = m.name_en = "leg"
    m.description = m.description_en = ""
    m.extra_uv_count = 0
    m.positions = np.array([[0, 5, 0]], np.float32)
    m.normals = np.array([[0, 0, -1]], np.float32)
    m.uvs = np.zeros((1, 2), np.float32)
    m.extra_uvs = np.zeros((1, 0, 4), np.float32)
    m.skin_type = np.array([P.BDEF1], np.uint8)
    m.skin_bones = np.array([[0, -1, -1, -1]], np.int32)
    m.skin_weights = np.array([[1, 0, 0, 0]], np.float32)
    m.sdef_c = np.zeros((1, 3), np.float32)
    m.sdef_r0 = np.zeros((1, 3), np.float32)
    m.sdef_r1 = np.zeros((1, 3), np.float32)
    m.edge_scale = np.ones(1, np.float32)
    m.triangles = np.zeros((0, 3), np.int32)
    m.materials = []

    def bone(name, pos, parent, flags=P.BONE_ROTATABLE | P.BONE_VISIBLE, level=0):
        b = P.Bone(name, name, np.array(pos, np.float32), parent, level, flags)
        b.child_offset = np.zeros(3, np.float32)
        return b

    root = bone("root", [0, 5, 0], P.NONE, P.BONE_ROTATABLE | P.BONE_MOVABLE)
    hip = bone("hip", [0, 4, 0], 0)
    knee = bone("knee", [0, 2, 0], 1)
    ankle = bone("ankle", [0, 0, 0], 2)
    ik = bone("ik", [0, 0, 0], P.NONE,
              P.BONE_ROTATABLE | P.BONE_MOVABLE | P.BONE_HAS_IK, level=1)
    ik.ik_target = 3
    ik.ik_loop = 40
    ik.ik_angle = 2.0
    ik.ik_links = [
        P.IKLink(2, True, np.array([-np.pi, 0, 0], np.float32),
                 np.array([-0.008726646, 0, 0], np.float32)),  # knee: x in [-pi, -0.5deg]
        P.IKLink(1, False, np.zeros(3, np.float32), np.zeros(3, np.float32)),
    ]
    m.bones = [root, hip, knee, ankle, ik]
    m.morphs = []
    return m
