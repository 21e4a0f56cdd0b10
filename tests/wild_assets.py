"""Wild-asset stress generator: realistic-scale PMX/PMD/VMD byte builders.

No real redistributable MMD model is available in this offline environment,
so this module synthesizes files with the hazards real assets carry and the
hand-sized golden fixtures (test_golden_bytes.py) do not:

- PMX: >100-part material tables with accumulated base_shift, global toon
  references, shared/odd texture paths (backslashes, case variation),
  deep (25+ link) and DUPLICATED IK chains, duplicate bone names,
  out-of-order transform levels, append chains, fixed/local axes,
  post-physics bones, degenerate skinning weights (BDEF2 w=0/w=1,
  unnormalized BDEF4, SDEF on non-parent-child bones), ext-UV channels,
  nested group morphs, display frames, dozens of rigid bodies and joints.
  Schema per `reader/pmx_reader_impl.inl:17-449`.
- PMD: ShiftJIS names whose second byte is 0x5C ("表", "ソ" — the classic
  backslash-collision code points), halfwidth katakana, toon table and
  English extension block. Schema per `reader/pmd_reader_impl.inl:17-566`.
- VMD: keyframes UNSORTED in file order (real exports are), 15/20-byte name
  fields carrying junk bytes after the NUL terminator, keys past frame
  100000. Schema per `reader/vmd_reader_impl.inl:9-108`.

The writers here are test-side and independent of the package
(simple_mmd_renderer.formats.writers is never imported).
"""

import struct

import numpy as np

from simple_mmd_renderer.formats import pmx as P
from simple_mmd_renderer.utils.io import encode_shift_jis


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


def text(s):
    payload = s.encode("utf-16-le")
    return i32(len(payload)) + payload


# index sizes chosen like mid-size wild models: u2 vertices, u1 textures,
# u1 materials, u2 bones, u1 morphs, u2 rigids
IDX = dict(vert="<H", tex="<B", mat="<B", bone="<H", morph="<B", rigid="<H")
NONE = dict(vert=0xFFFF, tex=0xFF, mat=0xFF, bone=0xFFFF, morph=0xFF,
            rigid=0xFFFF)


def idx(kind, v):
    return struct.pack(IDX[kind], NONE[kind] if v is None or v < 0 else v)


N_VERTS = 3200
N_TRIS = 4000
N_MATS = 120
N_TEXS = 24
N_BONES = 90
N_RIGID = 48
N_JOINTS = 40
IK_DEEP = 30          # bones 0..29 form one deep chain
# 8 IK links is deep for the wild population (legs are 2-3; special models
# reach ~8-10 — longer chains ride physics, not IK). The engine's link loop
# unrolls O(L^2) chain refreshes into the solver body, so this also keeps
# CPU test compiles sane.
IK_LINKS = 8


def build_wild_pmx(seed=0) -> bytes:
    rng = np.random.default_rng(seed)
    b = bytearray()
    b += b"PMX " + f(2.0) + u8(8)
    b += u8(0, 2, 2, 1, 1, 2, 1, 2)   # utf16le, 2 ext uvs, index sizes
    b += text("ワイルド・モデル（検証用）") + text("WildModel v1.2")
    b += text("圧力テスト：実在アセット規模の構成") + text("stress comment")

    # --- vertices: blob around origin, every skinning kind incl. degenerate
    pos = rng.normal(0.0, 4.0, (N_VERTS, 3)).astype(np.float32)
    pos[:, 1] = np.abs(pos[:, 1]) + 2.0
    nrm = pos / np.maximum(np.linalg.norm(pos, axis=1, keepdims=True), 1e-6)
    uv = rng.random((N_VERTS, 2)).astype(np.float32)
    b += i32(N_VERTS)
    for i in range(N_VERTS):
        b += f(*pos[i], *nrm[i], *uv[i])
        b += f(*rng.random(4, dtype=np.float32))    # ext uv 1
        b += f(*rng.random(4, dtype=np.float32))    # ext uv 2
        k = i % 7
        if k == 0:
            b += i8(P.BDEF1) + idx("bone", i % N_BONES)
        elif k == 1:                                 # plain BDEF2
            b += i8(P.BDEF2) + idx("bone", i % IK_DEEP)
            b += idx("bone", (i + 1) % IK_DEEP) + f(0.35)
        elif k == 2:                                 # degenerate w=1 -> BDEF1
            b += i8(P.BDEF2) + idx("bone", 3) + idx("bone", 4) + f(1.0)
        elif k == 3:                                 # degenerate w=0 -> BDEF1
            b += i8(P.BDEF2) + idx("bone", 5) + idx("bone", 6) + f(0.0)
        elif k == 4:                                 # unnormalized BDEF4
            b += i8(P.BDEF4)
            b += idx("bone", 1) + idx("bone", 2) + idx("bone", 3)
            b += idx("bone", None)
            b += f(0.5, 0.3, 0.4, 0.0)               # sums to 1.2
        elif k == 5:                                 # SDEF, parent-child pair
            b += i8(P.SDEF) + idx("bone", 1) + idx("bone", 2) + f(0.6)
            b += f(0, 5, 0) + f(0, 4, 0) + f(0, 6, 0)
        else:                                        # SDEF, NON-parent-child
            b += i8(P.SDEF) + idx("bone", 10) + idx("bone", 40) + f(0.5)
            b += f(1, 1, 1) + f(0, 0, 0) + f(2, 2, 2)
        b += f(float(i % 3) * 0.5)                   # edge scale

    # --- triangles
    tris = rng.integers(0, N_VERTS, (N_TRIS, 3)).astype(np.int64)
    b += i32(N_TRIS * 3)
    for t in tris.reshape(-1):
        b += idx("vert", int(t))

    # --- textures: odd paths, backslashes, case variation, duplicates
    texture_paths = []
    for i in range(N_TEXS):
        style = i % 4
        if style == 0:
            texture_paths.append(f"tex\\体{i:02d}.png")       # backslash dir
        elif style == 1:
            texture_paths.append(f"TEX/Body_{i:02d}.PNG")     # case variation
        elif style == 2:
            texture_paths.append(f"スフィア/metal{i:02d}.sph")
        else:
            texture_paths.append(f"toon_custom{i:02d}.bmp")
    b += i32(N_TEXS)
    for p in texture_paths:
        b += text(p)

    # --- 120 materials; triangle counts partition N_TRIS*3 indices
    counts = np.full(N_MATS, N_TRIS // N_MATS, np.int64)
    counts[: N_TRIS % N_MATS] += 1
    assert counts.sum() == N_TRIS
    b += i32(N_MATS)
    for m in range(N_MATS):
        b += text(f"材質{m:03d}・布") + text(f"mat{m:03d}")
        b += f(*rng.random(3, dtype=np.float32), 1.0)    # diffuse
        b += f(0.2, 0.2, 0.2) + f(10.0 + m)              # specular, shininess
        b += f(0.4, 0.4, 0.4)                            # ambient
        flags = 0x1F if m % 3 == 0 else (P.MAT_GROUND_SHADOW
                                         | (P.MAT_DOUBLE_FACE
                                            if m % 5 == 0 else 0))
        b += u8(flags)
        b += f(0.2, 0.1, 0.1, 1.0) + f(1.0)              # edge color/size
        b += idx("tex", m % N_TEXS)                      # diffuse texture
        sub = m % 3
        if sub == 0:
            b += idx("tex", None) + u8(0)                # no sphere
        else:
            b += idx("tex", (m + 2) % N_TEXS) + u8(sub)  # SPH / SPA
        if m % 2 == 0:
            b += u8(1) + u8(m % 10)                      # GLOBAL toon 0-9
        else:
            b += u8(0) + idx("tex", (m + 3) % N_TEXS)    # model-local toon
        b += text("メモ" * (m % 3))
        b += i32(int(counts[m]) * 3)

    # --- bones
    b += i32(N_BONES)
    base = (P.BONE_ROTATABLE | P.BONE_MOVABLE | P.BONE_VISIBLE
            | P.BONE_CONTROLLABLE)

    def bone(name, en, pos3, parent, level, flags, body: bytes):
        out = text(name) + text(en) + f(*pos3)
        out += idx("bone", parent) + i32(level) + u16(flags)
        return out + body

    # 0..29: deep chain down the y axis (IK chain fodder)
    for i in range(IK_DEEP):
        nm = f"長鎖{i:02d}"
        b += bone(nm, f"chain{i:02d}", (0.0, 20.0 - 0.6 * i, 0.0),
                  i - 1 if i else None, 0, base, f(0, -0.6, 0))
    # 30: IK bone driving the deep chain, 25 links, euler-limited knees
    links = bytearray()
    for li in range(IK_LINKS):
        links += idx("bone", IK_DEEP - 2 - li)
        if li % 2 == 0:
            links += i8(1) + f(-3.1415, 0, 0) + f(0, 0, 0)
        else:
            links += i8(0)
    b += bone("足ＩＫ左", "leg_ik_L", (0.0, 2.0, 0.0), None, 1,
              base | P.BONE_HAS_IK,
              f(0, 1, 0) + idx("bone", IK_DEEP - 1) + i32(255) + f(1.0)
              + i32(IK_LINKS) + bytes(links))
    # 31: second IK bone REUSING a subset of the same links (duplicated
    # chain — wild models alias IK chains across limbs)
    links2 = bytearray()
    for li in range(6):
        links2 += idx("bone", 27 - li) + i8(0)
    b += bone("足ＩＫ右", "leg_ik_R", (0.5, 2.0, 0.0), None, 1,
              base | P.BONE_HAS_IK,
              f(0, 1, 0) + idx("bone", 29) + i32(40) + f(0.5)
              + i32(6) + bytes(links2))
    # 32..89: misc bones exercising every optional block
    for i in range(32, N_BONES):
        flags = base
        body = f(0, 1, 0)                        # child offset default
        nm, en = f"骨{i}", f"b{i}"
        if i % 9 == 0:
            nm, en = "腕", "arm"                 # DUPLICATE names
        parent = (i - 1) % 32
        level = (7 - i) % 4                      # out-of-order levels
        if i % 4 == 0:
            flags |= P.BONE_CHILD_USE_ID
            body = idx("bone", (i + 1) % N_BONES)
        if i % 5 == 0:
            flags |= P.BONE_APPEND_ROTATE
            body += idx("bone", i % 30) + f(0.7)
        if i % 6 == 0:
            flags |= P.BONE_APPEND_TRANSLATE
            if not flags & P.BONE_APPEND_ROTATE:
                body += idx("bone", i % 30) + f(-0.3)
        if i % 7 == 0:
            flags |= P.BONE_ROT_AXIS_FIXED
            body += f(0, 0, 1)
        if i % 8 == 0:
            flags |= P.BONE_USE_LOCAL_AXIS
            body += f(1, 0, 0) + f(0, 0, 1)
        if i % 10 == 0:
            flags |= P.BONE_RECEIVE_TRANSFORM
            body += i32(i)
        if i % 11 == 0:
            flags |= P.BONE_POST_PHYSICS
        b += bone(nm, en, tuple(rng.normal(0, 3, 3).astype(float)),
                  parent, level, flags, body)

    # --- morphs: every kind, nested groups, ext-UV channels
    n_morphs = 14
    b += i32(n_morphs)
    # 0: group -> {2, 3}
    b += text("まとめ") + text("grp") + u8(4, P.MORPH_GROUP) + i32(2)
    b += idx("morph", 2) + f(0.5) + idx("morph", 3) + f(0.8)
    # 1: NESTED group -> {0} (recursion)
    b += text("入れ子") + text("nested") + u8(4, P.MORPH_GROUP) + i32(1)
    b += idx("morph", 0) + f(0.5)
    # 2: vertex morph over 200 verts
    b += text("頂点大") + text("vtx") + u8(2, P.MORPH_VERTEX) + i32(200)
    for v in range(200):
        b += idx("vert", v * 3 % N_VERTS) + f(0.1, -0.05, 0.02)
    # 3: bone morph
    b += text("ボーンM") + text("boneM") + u8(0, P.MORPH_BONE) + i32(3)
    for bi in (2, 5, 33):
        b += idx("bone", bi) + f(0, 0.5, 0) + f(0, 0, 0.2588, 0.9659)
    # 4: uv morph
    b += text("ＵＶ") + text("uvm") + u8(3, P.MORPH_UV) + i32(50)
    for v in range(50):
        b += idx("vert", v * 7 % N_VERTS) + f(0.1, 0.1, 0, 0)
    # 5-8: ext-uv morphs 1-4 (2 parse against declared ext uvs, all stored)
    for ch in range(4):
        b += text(f"拡張{ch}") + text(f"ext{ch}")
        b += u8(3, P.MORPH_EXT_UV_1 + ch) + i32(2)
        b += idx("vert", ch) + f(1, 2, 3, 4)
        b += idx("vert", ch + 8) + f(-1, -2, -3, -4)
    # 9: material morph, mul over ALL materials (none-index)
    b += text("全材質") + text("matAll") + u8(1, P.MORPH_MATERIAL) + i32(1)
    b += idx("mat", None) + u8(0) + f(*[0.5] * 28)
    # 10: material morph, add over two specific materials
    b += text("一部材質") + text("matAdd") + u8(1, P.MORPH_MATERIAL) + i32(2)
    b += idx("mat", 0) + u8(1) + f(*[0.1] * 28)
    b += idx("mat", 99) + u8(1) + f(*[0.2] * 28)
    # 11-13: plain vertex morphs (group targets etc.)
    for k in range(3):
        b += text(f"口{k}") + text(f"mouth{k}") + u8(3, P.MORPH_VERTEX)
        b += i32(4)
        for v in range(4):
            b += idx("vert", (k * 31 + v) % N_VERTS) + f(0, 0.2, 0)

    # --- display frames (parsed and discarded, reader:363-382)
    b += i32(3)
    b += text("Root") + text("Root") + u8(1) + i32(1) + u8(0) + idx("bone", 0)
    b += text("表情") + text("Exp") + u8(1) + i32(2)
    b += u8(1) + idx("morph", 2) + u8(1) + idx("morph", 4)
    b += text("物理") + text("Phys") + u8(0) + i32(3)
    b += u8(0) + idx("bone", 30) + u8(0) + idx("bone", 31)
    b += u8(1) + idx("morph", 0)

    # --- rigid bodies: chains of capsules on the deep chain + statics
    b += i32(N_RIGID)
    for r in range(N_RIGID):
        b += text(f"剛体{r:02d}") + text(f"rb{r:02d}")
        if r < 28:                                # follow chain bones
            b += idx("bone", r + 1)
            btype = P.RIGID_PHYSICS if r % 4 else P.RIGID_KINEMATIC
            shape = P.SHAPE_CAPSULE if r % 2 else P.SHAPE_SPHERE
        else:
            b += idx("bone", 32 + (r % 40))
            btype = (P.RIGID_PHYSICS_STRICT if r % 3 == 0
                     else P.RIGID_PHYSICS_GHOST if r % 3 == 1
                     else P.RIGID_PHYSICS)
            shape = P.SHAPE_BOX
        b += u8(r % 16) + u16(0xFFFF ^ (1 << (r % 16))) + u8(shape)
        b += f(0.3, 0.8, 0.3)
        b += f(0.0, 19.0 - 0.6 * min(r, 28), 0.0) + f(0, 0, 0.1)
        b += f(0.5 + 0.1 * (r % 5), 0.3, 0.3, 0.1, 0.4)
        b += u8(btype)

    # --- joints linking consecutive chain bodies
    b += i32(N_JOINTS)
    for j in range(N_JOINTS):
        a, c = j % (N_RIGID - 1), j % (N_RIGID - 1) + 1
        b += text(f"接続{j:02d}") + text(f"j{j:02d}") + u8(0)
        b += idx("rigid", a) + idx("rigid", c)
        b += f(0.0, 18.7 - 0.6 * min(j, 27), 0.0) + f(0, 0, 0)
        b += f(0, 0, 0) + f(0, 0, 0)
        b += f(-0.3, -0.3, -0.3) + f(0.3, 0.3, 0.3)
        b += f(0, 0, 0) + f(20, 20, 20)
    return bytes(b)


# --------------------------------------------------------------------------
# Wild PMD: ShiftJIS hazards at PMD 1.0 scale
# --------------------------------------------------------------------------

# names whose ShiftJIS encoding contains 0x5C ('\\') as a trail byte — the
# classic mojibake trap (表 = 95 5C, ソ = 83 5C, 十 = 8F 5C)
SJIS_TRAPS = ["表情ソ", "十字砲火", "予測能"]
HALFWIDTH = "ﾊｰﾌｳｲﾄﾞｽ"                      # halfwidth katakana


def build_wild_pmd(seed=1) -> bytes:
    rng = np.random.default_rng(seed)
    out = bytearray()
    w = out.extend
    w(b"Pmd" + struct.pack("<f", 1.0))
    w(encode_shift_jis("ワイルド" + SJIS_TRAPS[0], 20))
    w(encode_shift_jis("説明：" + SJIS_TRAPS[1] + HALFWIDTH, 256))

    nv = 600
    w(struct.pack("<I", nv))
    pos = rng.normal(0, 3, (nv, 3)).astype(np.float32)
    pos[:, 1] = np.abs(pos[:, 1]) + 1.0
    for i in range(nv):
        w(struct.pack("<8f", *pos[i], 0, 1, 0, (i % 17) / 17, (i % 9) / 9))
        w(struct.pack("<hhBB", i % 12, (i + 1) % 12, i * 7 % 101, i % 2))

    nt = 700
    tris = rng.integers(0, nv, (nt, 3))
    w(struct.pack("<I", nt * 3))
    for t in tris.reshape(-1):
        w(struct.pack("<H", int(t)))

    # 18 materials with toon indices incl. -1 and 9, tex*sph pairs
    nm = 18
    counts = np.full(nm, nt // nm, np.int64)
    counts[: nt % nm] += 1
    w(struct.pack("<I", nm))
    for m in range(nm):
        w(struct.pack("<4f", *rng.random(3).astype(float), 1.0))
        w(struct.pack("<f", 12.0))
        w(struct.pack("<3f", 0.2, 0.2, 0.2))
        w(struct.pack("<3f", 0.5, 0.5, 0.5))
        w(struct.pack("<bB", (m % 11) - 1, m % 2))   # toon -1..9, edge flag
        w(struct.pack("<I", int(counts[m]) * 3))
        tex = (f"body{m:02d}.bmp*metal.sph" if m % 3 == 0
               else f"かお{m:02d}.png" if m % 3 == 1 else "")
        w(encode_shift_jis(tex, 20))

    # 12 bones incl. trap names and an IK setup
    bones = []
    for i in range(12):
        nm_b = (SJIS_TRAPS[i % 3] if i % 4 == 0 else f"骨{i}")
        parent = i - 1 if i else -1
        child = i + 1 if i < 11 else -1
        btype = 2 if i == 11 else (1 if i < 2 else 0)
        bones.append((nm_b, parent, child, btype, 0,
                      (0.0, 12.0 - i, 0.0)))
    w(struct.pack("<H", len(bones)))
    for nm_b, parent, child, btype, ikn, p3 in bones:
        w(encode_shift_jis(nm_b, 20))
        w(struct.pack("<hhBh3f", parent, child, btype, ikn, *p3))

    # IK: bone 11 targets 10, chain [9, 8, 7]
    w(struct.pack("<H", 1))
    w(struct.pack("<hhBHf", 11, 10, 3, 30, 0.8))
    w(struct.pack("<3H", 9, 8, 7))

    # skins (morphs): base + 2
    w(struct.pack("<H", 3))
    base_idx = [0, 5, 9, 14]
    w(encode_shift_jis("base", 20))
    w(struct.pack("<IB", len(base_idx), 0))
    for bi in base_idx:
        w(struct.pack("<I3f", bi, *pos[bi].astype(float)))
    for k in range(2):
        w(encode_shift_jis(SJIS_TRAPS[k] if k == 0 else "ウィンク", 20))
        w(struct.pack("<IB", 2, 1 + k))
        for j in range(2):
            w(struct.pack("<I3f", j, 0.0, 0.3, 0.0))

    # display lists: skin indices, bone frame names, bone map
    w(struct.pack("<B", 2) + struct.pack("<2H", 1, 2))
    w(struct.pack("<B", 1))
    w(encode_shift_jis("枠" + HALFWIDTH, 50))
    w(struct.pack("<I", 2))
    w(struct.pack("<HB", 1, 1) + struct.pack("<HB", 2, 1))

    # english extension block
    w(struct.pack("<B", 1))
    w(encode_shift_jis("WildPmd", 20))
    w(encode_shift_jis("english comment", 256))
    for i in range(12):
        w(encode_shift_jis(f"bone{i}", 20))
    for i in range(2):                     # skins minus base
        w(encode_shift_jis(f"skin{i}", 20))
    w(encode_shift_jis("frame_en", 50))

    # toon table: 10 entries of 100 bytes
    for i in range(10):
        w(encode_shift_jis(f"toon{i:02d}.bmp", 100))

    # rigid bodies + joints
    w(struct.pack("<I", 3))
    for r in range(3):
        w(encode_shift_jis(f"剛体{r}", 20))
        w(struct.pack("<hBHB", r + 1, r, 0xFFFF, 2 if r else 0))
        w(struct.pack("<3f", 0.4, 1.0, 0.4))
        w(struct.pack("<3f", 0.0, 10.0 - r, 0.0))
        w(struct.pack("<3f", 0, 0, 0))
        w(struct.pack("<5f", 1.0, 0.3, 0.3, 0.1, 0.4))
        w(struct.pack("<B", 1 if r else 0))
    w(struct.pack("<I", 2))
    for j in range(2):
        w(encode_shift_jis(f"接続{j}", 20))
        w(struct.pack("<2I", j, j + 1))
        w(struct.pack("<3f", 0.0, 9.5 - j, 0.0) + struct.pack("<3f", 0, 0, 0))
        w(struct.pack("<3f", 0, 0, 0) * 2)
        w(struct.pack("<3f", -0.5, -0.5, -0.5) + struct.pack("<3f", .5, .5, .5))
        w(struct.pack("<3f", 0, 0, 0) + struct.pack("<3f", 15, 15, 15))
    return bytes(out)


# --------------------------------------------------------------------------
# Wild VMD: unsorted keys, junk after NUL, far frames
# --------------------------------------------------------------------------

def _name15_with_junk(name: str, rng) -> bytes:
    """15-byte ShiftJIS name field with random junk AFTER the terminator —
    real exporters leave uninitialized buffer bytes there."""
    enc = name.encode("cp932")[:14]
    junk = bytes(rng.integers(1, 255, 15 - len(enc) - 1).tolist())
    return enc + b"\x00" + junk


def build_wild_vmd(seed=2) -> bytes:
    rng = np.random.default_rng(seed)
    out = bytearray()
    out += b"Vocaloid Motion Data 0002" + b"\x00" * 5
    out += encode_shift_jis("ワイルドモーション", 20)

    bones = ["センター", SJIS_TRAPS[0], "長鎖05", "腕"]
    frames = [0, 100663, 7, 3000, 42, 1]       # deliberately unsorted
    recs = []
    for nm in bones:
        for fr in frames:
            recs.append((nm, fr))
    rng.shuffle(recs)
    out += struct.pack("<I", len(recs))
    for nm, fr in recs:
        out += _name15_with_junk(nm, rng)
        out += struct.pack("<I", fr)
        out += struct.pack("<3f", 0.0, 0.01 * fr % 5.0, 0.0)
        q = np.array([0, np.sin(fr * 0.001), 0, np.cos(fr * 0.001)])
        out += struct.pack("<4f", *(q / np.linalg.norm(q)))
        # MMD default curve per channel: c0=(20,20), c1=(107,107) at the
        # stride-4 offsets [0]=c0.x [4]=c0.y [8]=c1.x [12]=c1.y
        interp = np.zeros(64, np.uint8)
        for ch in range(4):
            interp[ch * 16 + 0] = 20
            interp[ch * 16 + 4] = 20
            interp[ch * 16 + 8] = 107
            interp[ch * 16 + 12] = 107
        out += interp.tobytes()

    morphs = ["まばたき", SJIS_TRAPS[2]]
    mrecs = [(nm, fr) for nm in morphs for fr in (500, 0, 90000, 30)]
    rng.shuffle(mrecs)
    out += struct.pack("<I", len(mrecs))
    for nm, fr in mrecs:
        enc = nm.encode("cp932")[:14]
        out += enc + b"\x00" + bytes(rng.integers(1, 255,
                                                  15 - len(enc) - 1).tolist())
        out += struct.pack("<If", fr, (fr % 100) / 100.0)

    out += struct.pack("<I", 0)                # no camera keys
    return bytes(out)
