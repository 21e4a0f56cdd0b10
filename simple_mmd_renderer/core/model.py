"""Model build: PMX parse output -> static rig program + device arrays.

Plays the role of libmmd's `Model` container plus the precomputation half of
`Poser`'s constructor (`motion/poser_impl.inl:16-128`): bone topology images,
IK limit classification (euler order + fixed-axis types), the pre/post-physics
bone partition sorted by (transform_level, index), group-morph expansion, and
`Model::Normalize` (`model/model_impl.inl:405-452`).

Everything static (topology, processing order, IK programs) stays host-side
NumPy and is baked into the jitted pose program at trace time — the JAX
equivalent of shader specialization. Only per-frame pose inputs are traced.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..formats import pmx as P

# IK link fix types (BoneImage::FIX_*)
FIX_NONE, FIX_X, FIX_Y, FIX_Z, FIX_ALL = 0, 1, 2, 3, 4
# IK euler clamp orders (BoneImage::ORDER_*)
ORDER_YZX, ORDER_ZXY, ORDER_XYZ = "yzx", "zxy", "xyz"

_EPS = 1e-8
_HALF_PI = math.pi * 0.5


@dataclass
class IKProgram:
    """Static CCD program for one IK bone (poser_impl.inl:59-98, 168-310)."""
    bone: int                 # the IK effector-goal bone itself
    target: int               # bone chasing the goal
    links: np.ndarray         # [L] int, links[0] nearest the target
    link_parents: np.ndarray  # [L] int (-1 = none)
    limited: np.ndarray       # [L] bool
    limits_min: np.ndarray    # [L,3] f32
    limits_max: np.ndarray    # [L,3] f32
    fix_types: np.ndarray     # [L] int
    orders: list[str]         # [L] euler order names
    loop: int                 # ccd iterate limit, clamped to 256
    angle_limit: float


@dataclass
class Segment:
    """A run of non-IK FK bones (grouped in parallel levels) or a group of
    mutually-independent, same-shaped IK chains solved batched (e.g. the two
    legs) — see `_group_iks`."""
    kind: str                  # "fk" | "ik"
    levels: list[np.ndarray] = field(default_factory=list)  # for "fk"
    iks: list[IKProgram] = field(default_factory=list)      # for "ik"


@dataclass
class ModelStatic:
    name: str
    # --- geometry (NumPy; moved to device by the pose/skin/render stages)
    positions: np.ndarray      # [N,3] f32, MMD units
    normals: np.ndarray        # [N,3]
    uvs: np.ndarray            # [N,2]
    triangles: np.ndarray      # [T,3] i32
    skin_bones: np.ndarray     # [N,4] i32 (NONE -> 0)
    skin_weights: np.ndarray   # [N,4] f32 (slot weight 0 where padded)
    skin_type: np.ndarray      # [N] u8 (post-Normalize)
    sdef_c: np.ndarray
    sdef_r0: np.ndarray
    sdef_r1: np.ndarray
    # --- bones
    n_bones: int
    bone_names: list[str]
    bone_rest: np.ndarray      # [B,3]
    bone_parent: np.ndarray    # [B] i32 (-1 root)
    local_offset: np.ndarray   # [B,3] rest - parent_rest (or rest)
    append_parent: np.ndarray  # [B] i32 (-1 none)
    append_ratio: np.ndarray   # [B] f32
    append_rotate: np.ndarray  # [B] bool
    append_translate: np.ndarray  # [B] bool
    is_ik_link: np.ndarray     # [B] bool
    post_physics: np.ndarray   # [B] bool
    pre_segments: list[Segment]
    post_segments: list[Segment]
    # --- morphs
    morph_names: list[str]
    n_morphs: int
    # group-expansion: effective leaf rate_j = sum_i expand[i,j] * rate_i
    morph_expand: np.ndarray   # [M,M] f32 (sparse in practice; small M)
    vm_morph: np.ndarray       # [KV] i32 leaf morph id per vertex-morph entry
    vm_vertex: np.ndarray      # [KV] i32
    vm_offset: np.ndarray      # [KV,3] f32
    bm_morph: np.ndarray       # [KB] i32 (sorted by morph id = application order)
    bm_bone: np.ndarray        # [KB] i32
    bm_trans: np.ndarray       # [KB,3] f32
    bm_rot: np.ndarray         # [KB,4] f32
    # UV morphs (MORPH_UV on the primary channel, plus the four extra-UV
    # channels) and material morphs — the reference parses both and
    # applies neither (poser_impl.inl:355-358, model.inl morph setters);
    # application here is the opt-in AppConfig.apply_extended_morphs path
    um_morph: np.ndarray       # [KU] i32 leaf morph id
    um_vertex: np.ndarray      # [KU] i32
    um_offset: np.ndarray      # [KU,2] f32 (du, dv)
    # ext-UV channels 1-4 (MORPH_EXT_UV_*): offsets into extra_uvs, exposed
    # through pose.ext_uv_morph_offsets / Scene.morphed_extra_uvs for
    # custom-effect consumers (the built-in shader samples none of them)
    xum_morph: np.ndarray      # [KX] i32 leaf morph id
    xum_vertex: np.ndarray     # [KX] i32
    xum_channel: np.ndarray    # [KX] i32 channel 0-3
    xum_offset: np.ndarray     # [KX,4] f32
    extra_uvs: np.ndarray      # [N,E,4] f32 rest-pose extra UV channels
    mm_morph: np.ndarray       # [KM] i32 leaf morph id (part-expanded)
    mm_part: np.ndarray        # [KM] i32 (the -1 = all-materials form expanded)
    mm_method: np.ndarray      # [KM] i32 0=mul 1=add
    mm_payload: np.ndarray     # [KM,28] f32 (pmx material-morph field order)
    # --- parts / materials (render)
    part_base: np.ndarray      # [Pn] i32 first triangle
    part_count: np.ndarray     # [Pn] i32
    part_tex: np.ndarray       # [Pn] i32 texture table index (-1 none)
    # edge/outline data (invert-hull pass; the reference parses these and
    # never draws edges — RenderConfig.show_edges is the opt-in)
    edge_mag: np.ndarray       # [N] f32 vertex edge_scale x material edge_size
    edge_tris: np.ndarray      # [Te,3] i32 triangles of edge-flagged parts
    edge_tri_part: np.ndarray  # [Te] i32 owning part per edge triangle
    edge_colors: np.ndarray    # [Pn,4] f32 material edge colors
    nocull_tris: np.ndarray    # [T] bool — triangles of MAT_DOUBLE_FACE parts
    materials: list[P.Material]
    textures: list[str]
    # --- physics
    rigid_bodies: list[P.RigidBody]
    constraints: list[P.Constraint]
    # dense [N,B] LBS weight matrix for the matmul skinning path (ops/skinning);
    # None when N*B exceeds the memory budget (gather path used instead)
    skin_weight_dense: np.ndarray | None = None


def _classify_ik_link(lo: np.ndarray, hi: np.ndarray) -> tuple[str, int, np.ndarray, np.ndarray]:
    """Euler-order + fix-type classification (poser_impl.inl:74-91)."""
    lmin = np.minimum(lo, hi).astype(np.float32)
    lmax = np.maximum(lo, hi).astype(np.float32)
    order = ORDER_YZX
    if lmin[0] > -_HALF_PI and lmax[0] < _HALF_PI:
        order = ORDER_ZXY
    elif lmin[1] > -_HALF_PI and lmax[1] < _HALF_PI:
        order = ORDER_XYZ
    z = lambda i: abs(lmin[i]) < _EPS and abs(lmax[i]) < _EPS
    zx, zy, zz = z(0), z(1), z(2)
    if zx and zy and zz:
        fix = FIX_ALL
    elif zy and zz:
        fix = FIX_X
    elif zx and zz:
        fix = FIX_Y
    elif zx and zy:
        fix = FIX_Z
    else:
        fix = FIX_NONE
    return order, fix, lmin, lmax


def _expand_group_morphs(morphs: list[P.Morph]) -> np.ndarray:
    """Expansion matrix E: effective leaf rates = rates @ E.

    Mirrors the recursion in UpdateMorphTransform for MORPH_TYPE_GROUP
    (poser_impl.inl:334-339); cycles are cut (the reference would recurse
    forever on a cyclic group, which valid files don't contain).
    """
    m = len(morphs)
    expand = np.zeros((m, m), np.float32)

    def visit(root: int, idx: int, rate: float, depth: int):
        if depth > 8 or abs(rate) < _EPS:
            return
        mo = morphs[idx]
        if mo.type == P.MORPH_GROUP:
            for child, crate in zip(mo.group_indices, mo.group_rates):
                if 0 <= child < m:
                    visit(root, int(child), rate * float(crate), depth + 1)
        else:
            expand[root, idx] += rate

    for i in range(m):
        visit(i, i, 1.0, 0)
    return expand


def build_model(pm: P.PmxModel) -> ModelStatic:
    n_bones = len(pm.bones)

    # --- Model::Normalize (model_impl.inl:405-452): canonicalize skin tables
    skin_type = pm.skin_type.copy()
    skin_bones = pm.skin_bones.copy()
    skin_weights = pm.skin_weights.copy()
    parent_of = np.array([b.parent for b in pm.bones], np.int32) if n_bones else np.zeros(0, np.int32)
    for i in range(len(skin_type)):
        st = skin_type[i]
        if st == P.BDEF2:
            w = skin_weights[i, 0]
            if w == 0.0:
                skin_type[i] = P.BDEF1
                skin_bones[i] = [skin_bones[i, 1], -1, -1, -1]
                skin_weights[i] = [1, 0, 0, 0]
            elif w == 1.0:
                skin_type[i] = P.BDEF1
                skin_bones[i, 1:] = -1
                skin_weights[i] = [1, 0, 0, 0]
        elif st == P.SDEF:
            b0, b1 = skin_bones[i, 0], skin_bones[i, 1]
            ok = (0 <= b0 < n_bones and 0 <= b1 < n_bones and
                  (parent_of[b0] == b1 or parent_of[b1] == b0))
            if not ok:
                w = skin_weights[i, 0]
                if w == 0.0:
                    skin_type[i] = P.BDEF1
                    skin_bones[i] = [b1, -1, -1, -1]
                    skin_weights[i] = [1, 0, 0, 0]
                elif w == 1.0:
                    skin_type[i] = P.BDEF1
                    skin_bones[i, 1:] = -1
                    skin_weights[i] = [1, 0, 0, 0]
                else:
                    skin_type[i] = P.BDEF2

    # padded bone slots must be valid gather indices; weight 0 keeps them inert
    skin_bones_safe = np.where(skin_bones < 0, 0, skin_bones).astype(np.int32)

    # --- bone images
    rest = np.stack([b.position for b in pm.bones]) if n_bones else np.zeros((0, 3), np.float32)
    parent = parent_of
    local_offset = rest.copy()
    has_parent = parent >= 0
    local_offset[has_parent] -= rest[parent[has_parent]]

    append_parent = np.full(n_bones, -1, np.int32)
    append_ratio = np.zeros(n_bones, np.float32)
    append_rotate = np.zeros(n_bones, bool)
    append_translate = np.zeros(n_bones, bool)
    post_physics = np.zeros(n_bones, bool)
    is_ik_link = np.zeros(n_bones, bool)

    ik_programs: dict[int, IKProgram] = {}
    for i, b in enumerate(pm.bones):
        ar = b.has(P.BONE_APPEND_ROTATE)
        at = b.has(P.BONE_APPEND_TRANSLATE)
        if (ar or at) and 0 <= b.append_parent < n_bones:
            append_parent[i] = b.append_parent
            append_ratio[i] = b.append_ratio
            append_rotate[i] = ar
            append_translate[i] = at
        post_physics[i] = b.has(P.BONE_POST_PHYSICS)
        if b.has(P.BONE_HAS_IK) and b.ik_target >= 0 and b.ik_links:
            links = np.array([l.bone for l in b.ik_links], np.int32)
            limited = np.array([l.has_limit for l in b.ik_links], bool)
            orders, fixes, lmins, lmaxs = [], [], [], []
            for l in b.ik_links:
                if l.has_limit:
                    order, fix, lmin, lmax = _classify_ik_link(l.lo, l.hi)
                else:
                    order, fix = ORDER_YZX, FIX_NONE
                    lmin = lmax = np.zeros(3, np.float32)
                orders.append(order)
                fixes.append(fix)
                lmins.append(lmin)
                lmaxs.append(lmax)
                is_ik_link[l.bone] = True
            ik_programs[i] = IKProgram(
                bone=i, target=b.ik_target, links=links,
                link_parents=parent[links].astype(np.int32),
                limited=limited,
                limits_min=np.stack(lmins).astype(np.float32),
                limits_max=np.stack(lmaxs).astype(np.float32),
                fix_types=np.array(fixes, np.int32), orders=orders,
                loop=min(b.ik_loop, 256), angle_limit=float(b.ik_angle))

    # --- processing order: (transform_level, index), split pre/post physics
    levels_key = np.array([b.transform_level for b in pm.bones], np.int64)
    order_all = np.lexsort((np.arange(n_bones), levels_key))
    pre_order = [i for i in order_all if not post_physics[i]]
    post_order = [i for i in order_all if post_physics[i]]

    def _ancestors(b: int) -> set[int]:
        out = set()
        seen = 0
        while b >= 0 and seen < n_bones:
            out.add(b)
            b = int(parent[b])
            seen += 1
        return out

    def _signature(ik: IKProgram):
        return (len(ik.links), ik.loop, tuple(ik.fix_types.tolist()),
                tuple(ik.orders), tuple(ik.limited.tolist()))

    def _independent(a: IKProgram, b: IKProgram) -> bool:
        """Solving a and b simultaneously == sequentially: neither reads or
        writes state the other touches (incl. FK reads of ancestors)."""
        mod_a = set(a.links.tolist()) | {a.target}
        mod_b = set(b.links.tolist()) | {b.target}
        reads_b = set().union(*(
            _ancestors(x) for x in ([b.bone, b.target] + b.links.tolist())))
        reads_a = set().union(*(
            _ancestors(x) for x in ([a.bone, a.target] + a.links.tolist())))
        return not (mod_a & reads_b) and not (mod_b & reads_a)

    def _group_iks(run: list[IKProgram]) -> list[list[IKProgram]]:
        """Greedy batching of an adjacent run of IK segments: an IK joins an
        earlier group iff its shape matches and it is independent of EVERY
        chain between (reordering across dependents would change results —
        e.g. toe IKs depend on their leg IK and stay behind it)."""
        groups: list[list[IKProgram]] = []
        for ik in run:
            placed = False
            for gi in range(len(groups) - 1, -1, -1):
                g = groups[gi]
                indep = all(_independent(ik, other) for other in g)
                if not indep:
                    break  # cannot reorder past a dependent group
                if _signature(g[0]) == _signature(ik):
                    g.append(ik)
                    placed = True
                    break
            if not placed:
                groups.append([ik])
        return groups

    def build_segments(order: list[int]) -> list[Segment]:
        segments: list[Segment] = []
        fk_run: list[int] = []
        ik_run: list[IKProgram] = []

        def flush_ik():
            for group in _group_iks(ik_run):
                segments.append(Segment("ik", iks=group))
            ik_run.clear()

        def flush_fk():
            if fk_run:
                segments.append(Segment("fk", levels=_levelize(fk_run)))
                fk_run.clear()

        def _levelize(run: list[int]) -> list[np.ndarray]:
            """Group a sequential FK run into parallel levels: a bone may join
            level L only if its parent and append parent are not pending in
            level >= L within this run. Bones whose parent appears later in
            the run read its stale (pre-pass) matrix, matching the sequential
            reference; they can be placed immediately."""
            pos = {b: k for k, b in enumerate(run)}
            level_of: dict[int, int] = {}
            levels: list[list[int]] = []
            for k, b in enumerate(run):
                lv = 0
                for dep in (int(parent[b]), int(append_parent[b])):
                    if dep >= 0 and dep in pos and pos[dep] < k:
                        lv = max(lv, level_of[dep] + 1)
                level_of[b] = lv
                while len(levels) <= lv:
                    levels.append([])
                levels[lv].append(b)
            return [np.array(l, np.int32) for l in levels]

        for b in order:
            if b in ik_programs:
                flush_fk()
                ik_run.append(ik_programs[b])
            else:
                flush_ik()
                fk_run.append(b)
        flush_fk()
        flush_ik()
        return segments

    # --- morph tables
    morphs = pm.morphs
    expand = _expand_group_morphs(morphs)
    vm_m, vm_v, vm_o = [], [], []
    bm_m, bm_b, bm_t, bm_r = [], [], [], []
    um_m, um_v, um_o = [], [], []
    xum_m, xum_v, xum_c, xum_o = [], [], [], []
    mm_m, mm_p, mm_me, mm_pl = [], [], [], []
    n_parts = len(pm.materials)
    extra_uvs = getattr(pm, "extra_uvs", None)
    if extra_uvs is None:
        extra_uvs = np.zeros((len(pm.positions), 0, 4), np.float32)
    n_extra_uv = extra_uvs.shape[1]
    for mi, mo in enumerate(morphs):
        if mo.type == P.MORPH_VERTEX:
            vm_m.append(np.full(len(mo.vertex_indices), mi, np.int32))
            vm_v.append(mo.vertex_indices.astype(np.int32))
            vm_o.append(mo.vertex_offsets.astype(np.float32))
        elif mo.type == P.MORPH_BONE:
            bm_m.append(np.full(len(mo.bone_indices), mi, np.int32))
            bm_b.append(mo.bone_indices.astype(np.int32))
            bm_t.append(mo.bone_translations.astype(np.float32))
            bm_r.append(mo.bone_rotations.astype(np.float32))
        elif mo.type == P.MORPH_UV and mo.uv_vertex_indices is not None:
            um_m.append(np.full(len(mo.uv_vertex_indices), mi, np.int32))
            um_v.append(mo.uv_vertex_indices.astype(np.int32))
            um_o.append(mo.uv_offsets[:, :2].astype(np.float32))
        elif (mo.type in (P.MORPH_EXT_UV_1, P.MORPH_EXT_UV_2,
                          P.MORPH_EXT_UV_3, P.MORPH_EXT_UV_4)
              and mo.uv_vertex_indices is not None):
            ch = mo.type - P.MORPH_EXT_UV_1
            if ch < n_extra_uv:   # drop channels the model doesn't declare
                k = len(mo.uv_vertex_indices)
                xum_m.append(np.full(k, mi, np.int32))
                xum_v.append(mo.uv_vertex_indices.astype(np.int32))
                xum_c.append(np.full(k, ch, np.int32))
                xum_o.append(mo.uv_offsets[:, :4].astype(np.float32))
        elif mo.type == P.MORPH_MATERIAL and mo.material_indices is not None:
            for j in range(len(mo.material_indices)):
                parts = (range(n_parts) if mo.material_indices[j] < 0
                         else [int(mo.material_indices[j])])
                for p in parts:
                    mm_m.append(mi)
                    mm_p.append(p)
                    mm_me.append(int(mo.material_methods[j]))
                    mm_pl.append(mo.material_payload[j].astype(np.float32))
    cat = lambda xs, shape, dt: (np.concatenate(xs) if xs else np.zeros(shape, dt))

    # --- parts
    part_base = np.array([mt.base_shift for mt in pm.materials], np.int32)
    part_count = np.array([mt.n_triangles for mt in pm.materials], np.int32)
    part_tex = np.array([mt.texture for mt in pm.materials], np.int32)

    # --- edge/outline tables (MAT_DRAW_EDGE parts only)
    n_all_verts = len(pm.positions)
    edge_mag = np.zeros(n_all_verts, np.float32)
    e_tris, e_part = [], []
    vertex_edge = (pm.edge_scale if pm.edge_scale is not None
                   else np.ones(n_all_verts, np.float32))
    for p, mt in enumerate(pm.materials):
        if not (mt.draw_flags & P.MAT_DRAW_EDGE) or mt.edge_size <= 0:
            continue
        tri_p = pm.triangles[mt.base_shift:mt.base_shift + mt.n_triangles]
        vids = np.unique(tri_p)
        edge_mag[vids] = np.maximum(edge_mag[vids],
                                    vertex_edge[vids] * mt.edge_size)
        e_tris.append(tri_p.astype(np.int32))
        e_part.append(np.full(len(tri_p), p, np.int32))
    edge_tris = (np.concatenate(e_tris) if e_tris
                 else np.zeros((0, 3), np.int32))
    edge_tri_part = (np.concatenate(e_part) if e_part
                     else np.zeros(0, np.int32))
    edge_colors = np.stack([np.asarray(mt.edge_color, np.float32)
                            for mt in pm.materials]) if pm.materials else \
        np.zeros((0, 4), np.float32)
    nocull_tris = np.zeros(len(pm.triangles), bool)
    for mt in pm.materials:
        if mt.draw_flags & P.MAT_DOUBLE_FACE:
            nocull_tris[mt.base_shift:mt.base_shift + mt.n_triangles] = True

    n_verts = len(pm.positions)
    skin_weight_dense = None
    if n_bones and n_verts and n_verts * n_bones <= 64_000_000:
        from ..ops.skinning import build_weight_matrix
        skin_weight_dense = build_weight_matrix(
            skin_bones_safe, skin_weights.astype(np.float32), n_bones)

    return ModelStatic(
        name=pm.name,
        positions=pm.positions.astype(np.float32),
        normals=pm.normals.astype(np.float32),
        uvs=pm.uvs.astype(np.float32),
        triangles=pm.triangles.astype(np.int32),
        skin_bones=skin_bones_safe,
        skin_weights=skin_weights.astype(np.float32),
        skin_type=skin_type,
        sdef_c=pm.sdef_c, sdef_r0=pm.sdef_r0, sdef_r1=pm.sdef_r1,
        n_bones=n_bones,
        bone_names=[b.name for b in pm.bones],
        bone_rest=rest.astype(np.float32),
        bone_parent=parent.astype(np.int32),
        local_offset=local_offset.astype(np.float32),
        append_parent=append_parent, append_ratio=append_ratio,
        append_rotate=append_rotate, append_translate=append_translate,
        is_ik_link=is_ik_link, post_physics=post_physics,
        pre_segments=build_segments(pre_order),
        post_segments=build_segments(post_order),
        morph_names=[mo.name for mo in morphs],
        n_morphs=len(morphs),
        morph_expand=expand,
        vm_morph=cat(vm_m, (0,), np.int32),
        vm_vertex=cat(vm_v, (0,), np.int32),
        vm_offset=cat(vm_o, (0, 3), np.float32),
        bm_morph=cat(bm_m, (0,), np.int32),
        bm_bone=cat(bm_b, (0,), np.int32),
        bm_trans=cat(bm_t, (0, 3), np.float32),
        bm_rot=cat(bm_r, (0, 4), np.float32),
        um_morph=cat(um_m, (0,), np.int32),
        um_vertex=cat(um_v, (0,), np.int32),
        um_offset=cat(um_o, (0, 2), np.float32),
        xum_morph=cat(xum_m, (0,), np.int32),
        xum_vertex=cat(xum_v, (0,), np.int32),
        xum_channel=cat(xum_c, (0,), np.int32),
        xum_offset=cat(xum_o, (0, 4), np.float32),
        extra_uvs=extra_uvs.astype(np.float32),
        mm_morph=np.asarray(mm_m, np.int32),
        mm_part=np.asarray(mm_p, np.int32),
        mm_method=np.asarray(mm_me, np.int32),
        mm_payload=(np.stack(mm_pl).astype(np.float32) if mm_pl
                    else np.zeros((0, 28), np.float32)),
        part_base=part_base, part_count=part_count, part_tex=part_tex,
        edge_mag=edge_mag, edge_tris=edge_tris,
        edge_tri_part=edge_tri_part, edge_colors=edge_colors,
        nocull_tris=nocull_tris,
        materials=pm.materials, textures=pm.textures,
        rigid_bodies=pm.rigid_bodies, constraints=pm.constraints,
        skin_weight_dense=skin_weight_dense,
    )
