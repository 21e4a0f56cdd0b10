"""Sequential NumPy oracle of the reference posing semantics.

An independent, deliberately-slow reimplementation of the libmmd Poser pipeline
(morphs -> FK -> CCD IK -> skinning -> deform) used only as a golden oracle for
the vectorized JAX implementation. Written in our column-vector convention
(docs/CONVENTIONS.md); per-bone processing follows the reference order:
(transform_level, index), pre/post-physics partition.

Everything the oracle consumes is re-derived HERE from the raw PmxModel —
bone topology, local offsets, append links, IK euler-order/fix-type
classification (poser_impl.inl:30-105), Model::Normalize skinning demotion
(model_impl.inl:405-452) — NOT taken from core.model.build_model, so a bug in
the production rig-program derivation cannot hide from the golden tests.
"""

import numpy as np

from simple_mmd_renderer.formats import pmx as P

F = np.float32
EPS = 1e-8
# mmd_math_const_eps / pi (util/math.inl:24-25)
REF_EPS = 1e-7
HALF_PI = np.float32(np.pi * 0.5)

# BoneImage::FIX_* / ORDER_* (motion/poser.inl)
FIX_NONE, FIX_X, FIX_Y, FIX_Z, FIX_ALL = 0, 1, 2, 3, 4


class OracleIK:
    """IK program of one HAS_IK bone, classified per poser_impl.inl:60-105."""

    def __init__(self, bone_idx: int, b: P.Bone):
        self.bone = bone_idx
        self.target = b.ik_target
        self.loop = min(b.ik_loop, 256)      # poser_impl.inl:96
        self.angle_limit = b.ik_angle
        n = len(b.ik_links)
        self.links = [l.bone for l in b.ik_links]
        self.limited = [l.has_limit for l in b.ik_links]
        self.limits_min = [np.minimum(l.lo, l.hi).astype(F) for l in b.ik_links]
        self.limits_max = [np.maximum(l.lo, l.hi).astype(F) for l in b.ik_links]
        self.orders = ["yzx"] * n
        self.fix_types = [FIX_NONE] * n
        for j, l in enumerate(b.ik_links):
            if not l.has_limit:
                continue
            lmin, lmax = self.limits_min[j], self.limits_max[j]
            if lmin[0] > -HALF_PI and lmax[0] < HALF_PI:
                self.orders[j] = "zxy"
            elif lmin[1] > -HALF_PI and lmax[1] < HALF_PI:
                self.orders[j] = "xyz"
            zero = [abs(lmin[k]) < REF_EPS and abs(lmax[k]) < REF_EPS
                    for k in range(3)]
            if zero[0] and zero[1] and zero[2]:
                self.fix_types[j] = FIX_ALL
            elif zero[1] and zero[2]:
                self.fix_types[j] = FIX_X
            elif zero[0] and zero[2]:
                self.fix_types[j] = FIX_Y
            elif zero[0] and zero[1]:
                self.fix_types[j] = FIX_Z


def qmul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by + ay * bw + az * bx - ax * bz,
        aw * bz + az * bw + ax * by - ay * bx,
        aw * bw - (ax * bx + ay * by + az * bz)], F)


def qconj(q):
    return np.array([-q[0], -q[1], -q[2], q[3]], F)


def qmat3(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (z * x + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (z * z + x * x), 2 * (y * z - w * x)],
        [2 * (z * x - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]], F)


def axis_angle(axis, angle):
    n = np.linalg.norm(axis)
    if n < EPS:
        return np.array([0, 0, 0, 1], F)
    half = F(angle) * F(0.5)
    out = np.empty(4, F)
    out[:3] = (np.sin(half) / n) * axis
    out[3] = np.cos(half)
    return out


def slerp(a, b, t):
    comega = float(np.dot(a, b))
    flip = comega < 0
    if flip:
        comega = -comega
    omega = np.arccos(np.clip(comega, -1.0, 1.0))
    if omega > EPS:
        rs = 1.0 / np.sin(omega)
        p = np.sin((1.0 - t) * omega) * rs
        l = np.sin(t * omega) * rs
        if flip:
            l = -l
        return (a * p + b * l).astype(F)
    return a.copy()


def quat_to_euler(q, order):
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, zx, yz = x * y, z * x, y * z
    asin = lambda v: np.arcsin(np.clip(v, -1.0, 1.0))
    if order == "xyz":
        return np.array([np.arctan2(2 * (wx - yz), 1 - 2 * (xx + yy)),
                         asin(2 * (wy + zx)),
                         np.arctan2(2 * (wz - xy), 1 - 2 * (yy + zz))], F)
    if order == "yzx":
        return np.array([np.arctan2(2 * (wx - yz), 1 - 2 * (xx + zz)),
                         np.arctan2(2 * (wy - zx), 1 - 2 * (yy + zz)),
                         asin(2 * (wz + xy))], F)
    if order == "zxy":
        return np.array([asin(2 * (wx + yz)),
                         np.arctan2(2 * (wy - zx), 1 - 2 * (xx + yy)),
                         np.arctan2(2 * (wz - xy), 1 - 2 * (xx + zz))], F)
    raise ValueError(order)


def euler_to_quat(e, order):
    cx, sx = np.cos(e[0] * 0.5), np.sin(e[0] * 0.5)
    cy, sy = np.cos(e[1] * 0.5), np.sin(e[1] * 0.5)
    cz, sz = np.cos(e[2] * 0.5), np.sin(e[2] * 0.5)
    if order == "xyz":
        return np.array([sx * cy * cz + cx * sy * sz, cx * sy * cz - sx * cy * sz,
                         sx * sy * cz + cx * cy * sz, cx * cy * cz - sx * sy * sz], F)
    if order == "yzx":
        return np.array([sx * cy * cz + cx * sy * sz, cx * sy * cz + sx * cy * sz,
                         cx * cy * sz - sx * sy * cz, cx * cy * cz - sx * sy * sz], F)
    if order == "zxy":
        return np.array([sx * cy * cz - cx * sy * sz, cx * sy * cz + sx * cy * sz,
                         cx * cy * sz + sx * sy * cz, cx * cy * cz - sx * sy * sz], F)
    raise ValueError(order)


class OraclePoser:
    def __init__(self, pm: P.PmxModel):
        self.pm = pm
        self.B = len(pm.bones)
        self.N = len(pm.positions)
        self.n_morphs = len(pm.morphs)

        # --- bone topology from raw bones (poser_impl.inl:30-47)
        self.bone_parent = np.array(
            [b.parent if 0 <= b.parent < self.B else -1 for b in pm.bones],
            np.int64)
        self.bone_rest = np.stack([b.position for b in pm.bones]) \
            if self.B else np.zeros((0, 3), F)
        self.local_offset = np.stack([
            (b.position - pm.bones[b.parent].position)
            if 0 <= b.parent < self.B else b.position
            for b in pm.bones]) if self.B else np.zeros((0, 3), F)
        self.append_parent = np.full(self.B, -1, np.int64)
        self.append_rotate = np.zeros(self.B, bool)
        self.append_translate = np.zeros(self.B, bool)
        self.append_ratio = np.zeros(self.B, F)
        for i, b in enumerate(pm.bones):
            ar = b.has(P.BONE_APPEND_ROTATE)
            at = b.has(P.BONE_APPEND_TRANSLATE)
            if (ar or at) and 0 <= b.append_parent < self.B:
                self.append_parent[i] = b.append_parent
                self.append_rotate[i] = ar
                self.append_translate[i] = at
                self.append_ratio[i] = b.append_ratio

        # --- IK programs + link marking (poser_impl.inl:60-105)
        self.ik_programs = {}
        self.is_ik_link = np.zeros(self.B, bool)
        for i, b in enumerate(pm.bones):
            if b.has(P.BONE_HAS_IK):
                ik = OracleIK(i, b)
                self.ik_programs[i] = ik
                for l in ik.links:
                    self.is_ik_link[l] = True

        # --- processing order: (transform_level, index), pre/post partition
        order_key = np.lexsort((np.arange(self.B),
                                np.array([b.transform_level for b in pm.bones])))
        post = [b.has(P.BONE_POST_PHYSICS) for b in pm.bones]
        self.pre_order = [i for i in order_key if not post[i]]
        self.post_order = [i for i in order_key if post[i]]

        # --- skinning with Model::Normalize (model_impl.inl:405-452):
        # BDEF2 weight 0/1 -> BDEF1; SDEF of non-parent-child bones -> BDEF1/2;
        # deform treats SDEF like BDEF2 (poser_impl.inl:417-425 fallthrough)
        self.skin_bones = np.zeros((self.N, 4), np.int64)
        self.skin_weights = np.zeros((self.N, 4), F)
        for i in range(self.N):
            st_ = int(pm.skin_type[i])
            bs = pm.skin_bones[i]
            ws = pm.skin_weights[i]
            if st_ == P.BDEF1:
                self.skin_bones[i, 0] = max(bs[0], 0)
                self.skin_weights[i, 0] = 1.0
            elif st_ in (P.BDEF2, P.SDEF):
                w = float(ws[0])
                if w == 0.0:
                    self.skin_bones[i, 0] = max(bs[1], 0)
                    self.skin_weights[i, 0] = 1.0
                elif w == 1.0:
                    self.skin_bones[i, 0] = max(bs[0], 0)
                    self.skin_weights[i, 0] = 1.0
                else:
                    self.skin_bones[i, :2] = np.maximum(bs[:2], 0)
                    self.skin_weights[i, 0] = w
                    self.skin_weights[i, 1] = 1.0 - w
            else:  # BDEF4: weighted matrix sum, weights NOT renormalized
                self.skin_bones[i] = np.maximum(bs, 0)
                self.skin_weights[i] = ws

        self.reset()

    def reset(self):
        B, N = self.B, self.N
        self.rotation = np.tile(np.array([0, 0, 0, 1], F), (B, 1))
        self.translation = np.zeros((B, 3), F)
        self.morph_rates = np.zeros(self.n_morphs, F)
        self._clear_images()
        self.skin = np.tile(np.eye(4, dtype=F), (B, 1, 1))

    def _clear_images(self):
        B, N = self.B, self.N
        self.vertex_offsets = np.zeros((N, 3), F)
        self.morph_rot = np.tile(np.array([0, 0, 0, 1], F), (B, 1))
        self.morph_trans = np.zeros((B, 3), F)
        self.world = np.tile(np.eye(4, dtype=F), (B, 1, 1))
        self.total_rot = np.tile(np.array([0, 0, 0, 1], F), (B, 1))
        self.total_trans = np.zeros((B, 3), F)
        self.pre_ik = np.tile(np.array([0, 0, 0, 1], F), (B, 1))
        self.ik_rot = np.tile(np.array([0, 0, 0, 1], F), (B, 1))

    def set_bone_pose(self, i, trans, rot):
        self.translation[i] = trans
        self.rotation[i] = rot

    def set_morph(self, i, rate):
        self.morph_rates[i] = rate

    # --- morphs ---
    def _apply_morph(self, idx, rate):
        if rate < EPS:
            return
        mo = self.pm.morphs[idx]
        if mo.type == P.MORPH_GROUP:
            for child, crate in zip(mo.group_indices, mo.group_rates):
                self._apply_morph(int(child), float(crate) * rate)
        elif mo.type == P.MORPH_VERTEX:
            for v, off in zip(mo.vertex_indices, mo.vertex_offsets):
                self.vertex_offsets[v] += off * F(rate)
        elif mo.type == P.MORPH_BONE:
            for b, t, q in zip(mo.bone_indices, mo.bone_translations,
                               mo.bone_rotations):
                self.morph_trans[b] += t * F(rate)
                self.morph_rot[b] = qmul(
                    self.morph_rot[b],
                    slerp(np.array([0, 0, 0, 1], F), q.astype(F), rate))

    # --- FK ---
    def _fk(self, i):
        self.total_rot[i] = qmul(self.morph_rot[i], self.rotation[i])
        self.total_trans[i] = self.morph_trans[i] + self.translation[i]
        ap = self.append_parent[i]
        if ap >= 0:
            if self.append_rotate[i]:
                self.total_rot[i] = qmul(
                    self.total_rot[i],
                    slerp(np.array([0, 0, 0, 1], F), self.total_rot[ap],
                          float(self.append_ratio[i])))
            if self.append_translate[i]:
                self.total_trans[i] = (self.total_trans[i]
                                       + self.append_ratio[i] * self.total_trans[ap])
        if self.is_ik_link[i]:
            self.pre_ik[i] = self.total_rot[i].copy()
            self.total_rot[i] = qmul(self.ik_rot[i], self.total_rot[i])
        local = np.eye(4, dtype=F)
        local[:3, :3] = qmat3(self.total_rot[i])
        local[:3, 3] = self.total_trans[i] + self.local_offset[i]
        p = self.bone_parent[i]
        self.world[i] = (self.world[p] @ local) if p >= 0 else local
        if i in self.ik_programs:
            self._solve_ik(self.ik_programs[i])

    def _refresh_link(self, b):
        self.total_rot[b] = qmul(self.ik_rot[b], self.pre_ik[b])
        local = np.eye(4, dtype=F)
        local[:3, :3] = qmat3(self.total_rot[b])
        local[:3, 3] = self.total_trans[b] + self.local_offset[b]
        p = self.bone_parent[b]
        self.world[b] = (self.world[p] @ local) if p >= 0 else local

    def _solve_ik(self, ik: OracleIK):
        links = [int(x) for x in ik.links]
        for b in links:
            self.ik_rot[b] = np.array([0, 0, 0, 1], F)
        ik_position = self.world[ik.bone][:3, 3].copy()
        for b in reversed(links):
            self._fk(b)
        self._fk(ik.target)
        target_pos = self.world[ik.target][:3, 3].copy()
        err = ik_position - target_pos
        if float(err @ err) < EPS:
            return
        ikt = ik.loop // 2
        for i in range(ik.loop):
            for j, b in enumerate(links):
                if ik.fix_types[j] == FIX_ALL:
                    continue
                link_pos = self.world[b][:3, 3]
                target_dir = link_pos - target_pos
                ik_dir = link_pos - ik_position
                target_dir = target_dir / max(np.linalg.norm(target_dir), EPS)
                ik_dir = ik_dir / max(np.linalg.norm(ik_dir), EPS)
                axis = np.cross(target_dir, ik_dir).astype(F)
                for k in range(3):
                    if abs(axis[k]) < EPS:
                        axis[k] = F(EPS)
                p = self.bone_parent[b]
                loc = self.world[p] if p >= 0 else np.eye(4, dtype=F)
                if ik.limited[j] and ik.fix_types[j] != FIX_NONE and i < ikt:
                    k = {FIX_X: 0, FIX_Y: 1, FIX_Z: 2}[int(ik.fix_types[j])]
                    s = 1.0 if float(axis @ loc[:3, k]) >= 0 else -1.0
                    axis = np.zeros(3, F)
                    axis[k] = s
                else:
                    axis = loc[:3, :3].T @ axis
                    axis = axis / max(np.linalg.norm(axis), EPS)
                angle = min(float(np.arccos(np.clip(target_dir @ ik_dir, -1, 1))),
                            ik.angle_limit * (j + 1))
                self.ik_rot[b] = qmul(axis_angle(axis, angle), self.ik_rot[b])
                if ik.limited[j]:
                    local_rotation = qmul(self.ik_rot[b], self.pre_ik[b])
                    order = ik.orders[j]
                    e = quat_to_euler(local_rotation, order)
                    emin, emax = ik.limits_min[j], ik.limits_max[j]
                    for k in range(3):
                        if e[k] < emin[k]:
                            tf = 2 * emin[k] - e[k]
                            e[k] = tf if (tf <= emax[k] and i < ikt) else emin[k]
                        if e[k] > emax[k]:
                            tf = 2 * emax[k] - e[k]
                            e[k] = tf if (tf >= emin[k] and i < ikt) else emax[k]
                    local_rotation = euler_to_quat(e, order)
                    self.ik_rot[b] = qmul(local_rotation, qconj(self.pre_ik[b]))
                for k in range(j, -1, -1):
                    self._refresh_link(links[k])
                self._fk(ik.target)
                target_pos = self.world[ik.target][:3, 3].copy()
            err = ik_position - target_pos
            if float(err @ err) < EPS:
                return

    def _update_skin(self, order):
        for i in order:
            self.skin[i] = self.world[i].copy()
            self.skin[i][:3, 3] = (self.world[i][:3, 3]
                                   - self.world[i][:3, :3] @ self.bone_rest[i])

    def pre_physics(self):
        self._clear_images()
        for i in range(self.n_morphs):
            self._apply_morph(i, float(self.morph_rates[i]))
        for i in self.pre_order:
            self._fk(i)
        self._update_skin(self.pre_order)

    def post_physics(self):
        for i in self.post_order:
            self._fk(i)
        self._update_skin(self.post_order)

    def deform(self):
        pos = np.empty((self.N, 3), F)
        nrm = np.empty((self.N, 3), F)
        for i in range(self.N):
            m = np.zeros((4, 4), F)
            for k in range(4):
                w = self.skin_weights[i, k]
                if w != 0.0:
                    m += w * self.skin[self.skin_bones[i, k]]
            p = self.pm.positions[i] + self.vertex_offsets[i]
            pos[i] = m[:3, :3] @ p + m[:3, 3]
            nrm[i] = m[:3, :3] @ self.pm.normals[i]
        return pos, nrm
