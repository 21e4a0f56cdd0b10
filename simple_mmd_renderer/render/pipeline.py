"""Frame pipeline: shadow pass -> main pass (skybox, character, ground).

Array rebuild of the reference's per-frame render (`main.cpp:2011-2189`):

1. camera MVP (perspective RH_ZO 0.1-1000m) and directional-light ortho MVP
   (±5 m frustum, 0.1-100 m, light 50 m out) — `main.cpp:1896-2009`
2. shadow pass: depth-only raster of the character from the light,
   front-face culling (`main.cpp:898-957`)
3. main pass: skybox (cube sample + ACES), character (albedo/rim/Blinn-Phong
   per part texture), ground (white * 0.7 * 3x3 PCF shadow)

All passes render to HBM arrays; shading is deferred over visibility buffers.
Character vertices are fed in MMD units and scaled x0.1 to meters here, with
triangle winding flipped, exactly like the reference's vertex upload
(`main.cpp:753-754, 783-787`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..formats.textures import sample_bilinear
from ..utils import pytree
from ..utils.math3d import f32_matmul
from ..utils.profiling import pass_scope
from . import camera as cam
from . import ibl as ibl_mod
from . import raster
from . import shade


def build_matrices(cfg: RenderConfig, model_mat=None, aspect=None,
                   proj_transform=None):
    if model_mat is None:
        model_mat = jnp.eye(4, dtype=jnp.float32)
    if aspect is None:
        aspect = cfg.width / cfg.height
    proj = cam.perspective(jnp.deg2rad(cfg.camera_fov_deg), aspect,
                           cfg.near, cfg.far)
    ortho = cfg.camera_orthographic
    if not (isinstance(ortho, bool) and not ortho):
        # orthographic camera (VMD "perspective off"): frame height matches
        # the perspective frustum at the look-at distance, so toggling the
        # flag keeps the subject at the same screen size
        eye = jnp.asarray(cfg.camera_pos, jnp.float32)
        tgt = jnp.asarray(cfg.camera_target, jnp.float32)
        half_h = (jnp.linalg.norm(eye - tgt)
                  * jnp.tan(jnp.deg2rad(cfg.camera_fov_deg) * 0.5))
        half_w = half_h * aspect
        oproj = cam.orthographic(-half_w, half_w, -half_h, half_h,
                                 cfg.near, cfg.far)
        proj = jnp.where(jnp.asarray(ortho), oproj, proj)
    if proj_transform is not None:
        # linear clip-space window transform (e.g. a per-device framebuffer
        # band for tile-parallel rendering, parallel.mesh.frame_jit): applied
        # to proj so EVERY consumer — raster, ground ray cast, skybox rays,
        # depth unprojection — sees one consistent camera
        proj = jnp.asarray(proj_transform, jnp.float32) @ proj
    view = cam.look_at(cfg.camera_pos, cfg.camera_target,
                       jnp.array([0.0, 1.0, 0.0], jnp.float32))
    mvp = proj @ view @ model_mat

    hs = cfg.shadow_frustum_half
    light_proj = cam.orthographic(-hs, hs, -hs, hs, cfg.shadow_near,
                                  cfg.shadow_far)
    light_view = cam.directional_light_view(cfg.light_direction)
    light_mvp = light_proj @ light_view @ model_mat
    light_vp = light_proj @ light_view  # identity-model version (ground)
    return dict(model=model_mat, view=view, proj=proj, mvp=mvp,
                light_mvp=light_mvp, light_vp=light_vp)


def ground_geometry(size):
    """50 m white stage quad (CreateGroundGeometry, main.cpp:866-895)."""
    s = size
    verts = jnp.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]],
                      jnp.float32)
    tris = jnp.array([[0, 1, 2], [2, 3, 0]], jnp.int32)
    return verts, tris


def unproject_depth(depth, vp, width, height):
    """[H,W] NDC depth -> [H,W,3] world positions through inv(vp) (the same
    screen mapping as raster.screen_from_clip, inverted). Empty pixels
    (depth 1.0) unproject to the far plane; callers mask by coverage.

    Evaluated PLANAR (per-row FMAs on [H,W] planes), not as a [H,W,4]
    stack @ inv.T: every output channel is an elementwise fusion over the
    depth plane, with no [H,W,4] intermediate."""
    inv = jnp.linalg.inv(vp)
    xs = ((jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0
          - 1.0)[None, :]
    ys = (1.0 - (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
          * 2.0)[:, None]

    def row(i):
        return (inv[i, 0] * xs + inv[i, 1] * ys + inv[i, 2] * depth
                + inv[i, 3])

    pw = row(3)
    pw = jnp.where(jnp.abs(pw) > 1e-12, pw, 1e-12)
    return jnp.stack([row(0) / pw, row(1) / pw, row(2) / pw], -1)


def ground_pass(cfg: RenderConfig, view, proj, width, height, row0=0,
                rows=None):
    """Analytic ray/plane ground raster: exactly the 50 m y=0 quad, but immune
    to near-plane clipping (the quad always crosses the near plane, which a
    guard-band triangle raster would drop). -> (mask, world_pos, ndc_depth).

    `row0`/`rows` evaluate a row RANGE [row0, row0+rows) of the height-pixel
    grid (row0 may be negative): the downsampled shadow-lookup path renders
    one geometric halo row beyond each edge so its bilinear upsample blends
    true neighbor values — which makes a row-banded frame (parallel.mesh.
    frame_jit) seamless, because each band's halo rows ARE the neighbor
    band's edge rows."""
    rows = height if rows is None else rows
    eye = jnp.asarray(cfg.camera_pos, jnp.float32)
    vp = proj @ view
    inv = jnp.linalg.inv(vp)
    # planar evaluation throughout (see unproject_depth)
    xs = ((jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0
          - 1.0)[None, :]
    ys = (1.0 - (jnp.arange(rows, dtype=jnp.float32) + row0 + 0.5) / height
          * 2.0)[:, None]

    def row(i):  # inv @ (x, y, 0.5, 1)
        return (inv[i, 0] * xs + inv[i, 1] * ys
                + (inv[i, 2] * 0.5 + inv[i, 3]))

    pw = row(3)
    pw = jnp.where(jnp.abs(pw) > 1e-12, pw, 1.0)
    wx, wy, wz = row(0) / pw, row(1) / pw, row(2) / pw
    dx_, dy, dz_ = wx - eye[0], wy - eye[1], wz - eye[2]
    t = -eye[1] / jnp.where(jnp.abs(dy) > 1e-9, dy, 1e-9)
    hx = eye[0] + t * dx_
    hy = eye[1] + t * dy
    hz = eye[2] + t * dz_
    s = cfg.ground_size
    mask = ((t > 0) & (jnp.abs(dy) > 1e-9)
            & (jnp.abs(hx) <= s) & (jnp.abs(hz) <= s))
    # clip-space depth of the hit: only rows 2 and 3 of vp are needed
    cz = vp[2, 0] * hx + vp[2, 1] * hy + vp[2, 2] * hz + vp[2, 3]
    cw = vp[3, 0] * hx + vp[3, 1] * hy + vp[3, 2] * hz + vp[3, 3]
    depth = cz / jnp.where(jnp.abs(cw) > 1e-9, cw, 1.0)
    mask = mask & (depth >= 0.0) & (depth <= 1.0)
    hit = jnp.stack([hx, hy, hz], -1)
    return mask, hit, jnp.where(mask, depth, 1.0)


def upsample_bilinear_int(img, f, pre_padded_rows=False):
    """[h,w,1] -> [f*h, f*w, 1] bilinear upsample with half-pixel centers —
    identical math to jax.image.resize(..., method="linear") for an integer
    factor, but as f static per-phase plane blends per axis (edge-padded
    shifted slices with constant weights) instead of the general gather
    formulation. Measured NEUTRAL in-pipeline at 1080p (XLA already lowers
    the integer-factor resize well); kept because the plane form has no
    gathers to interact with the albedo window's gather-heavy neighborhood
    and is exact by construction (parity test).

    `pre_padded_rows`: the input's first and last ROW are halo rows (true
    neighbor values from a geometric halo, see ground_pass row0/rows) used
    as the row-axis padding instead of edge replication; output rows =
    f*(h-2). Columns always edge-pad."""
    import math as _math
    lo = img[..., 0]

    def axis_up(a, axis):
        if axis == 0 and pre_padded_rows:
            n = a.shape[0] - 2
            p = a
        else:
            n = a.shape[axis]
            pads = [(0, 0), (0, 0)]
            pads[axis] = (1, 1)
            p = jnp.pad(a, pads, mode="edge")
        outs = []
        for ph in range(f):
            o = (ph + 0.5) / f - 0.5
            fl = _math.floor(o)
            fr = o - fl
            s0 = jax.lax.slice_in_dim(p, 1 + fl, 1 + fl + n, axis=axis)
            s1 = jax.lax.slice_in_dim(p, 2 + fl, 2 + fl + n, axis=axis)
            outs.append(s0 * (1.0 - fr) + s1 * fr)
        st = jnp.stack(outs, axis=axis + 1)
        shape = list(a.shape)
        shape[axis] = n * f
        return st.reshape(shape)

    return axis_up(axis_up(lo, 0), 1)[..., None]


def _tiled_e_max(width, height, default=24):
    """Covers-all e_max at small targets (crowd viewports, small shadow
    maps): when the whole tile grid fits in <=16 entries/tri, binning every
    covered tile removes the big-tri fallback at trace time — which under
    vmap would otherwise run its full-frame scan for every instance."""
    from ..ops.tiled_raster import _grid
    n_tiles = _grid(width, height)[1]
    return n_tiles if n_tiles <= 16 else default


def _pick_raster(cfg):
    """raster_mode "tiled" or "scan", or "auto": the tile kernel on the GPU,
    the exact scan raster on the CPU (where the kernel only interprets)."""
    mode = cfg.raster_mode
    if mode == "auto":
        backend = jax.default_backend()
        if backend not in ("cpu", "gpu"):
            raise NotImplementedError(
                f"no raster for backend {backend!r}: expected cpu or gpu")
        mode = "tiled" if backend == "gpu" else "scan"
    if mode == "tiled":
        from ..ops.tiled_raster import rasterize_tiled
        return rasterize_tiled
    if mode != "scan":
        raise ValueError(f"raster_mode {cfg.raster_mode!r}: expected "
                         f"'auto', 'tiled' or 'scan'")
    return raster.rasterize


def shadow_pass(verts_m, tris_flipped, light_mvp, size, raster_fn=None,
                compact=True, corner_pos=None):
    """Depth-only character raster from the light (front-cull,
    main.cpp:942). `corner_pos` [T,3,3] may pass pre-gathered per-corner
    world positions (shared with the main pass — see render_frame): the
    light-space clip coords are then computed per corner, skipping this
    pass's own 3T-row vertex gather (the dominant setup cost)."""
    raster_fn = raster_fn or raster.rasterize
    clip = raster.transform_clip(verts_m, light_mvp)
    if raster_fn is not raster.rasterize:
        # depth-only kernel: ~half the per-entry ops of the full raster
        from ..ops.tiled_raster import rasterize_depth_tiled
        cv = (raster.transform_clip(corner_pos, light_mvp)
              if corner_pos is not None else None)
        return rasterize_depth_tiled(clip, tris_flipped, size, size,
                                     raster.CULL_FRONT,
                                     _tiled_e_max(size, size),
                                     compact=compact, cv=cv)
    vis = raster_fn(clip, tris_flipped, size, size, raster.CULL_FRONT)
    return vis.depth


def character_albedo(static, tri, uv_px, part_textures, atlas=None):
    """Per-part diffuse texture lookup (main.cpp:2093-2146: one draw + bind
    per part) from the triangle-id image `tri` [H,W]. Any real texture
    routes through the packed-neighborhood atlas: full bilinear from ONE
    gather per pixel. Flat-color-only parts keep the gather-free
    broadcast path. Pass `atlas` (PackedAtlas) through jit arguments for
    large texture sets (see PackedAtlas)."""
    import numpy as np
    real = [p for p, t in enumerate(part_textures)
            if t.shape[0] > 1 or t.shape[1] > 1]
    if atlas is not None or len(real) >= 1:
        return _albedo_atlas(static, tri, uv_px, part_textures, atlas)

    albedo = jnp.ones(tri.shape + (3,), jnp.float32)
    for p in range(len(static.part_base)):
        base = int(static.part_base[p])
        count = int(static.part_count[p])
        if count == 0:
            continue
        mask = (tri >= base) & (tri < base + count)
        tex = part_textures[p]
        if tex.shape[0] == 1 and tex.shape[1] == 1:
            color = jnp.broadcast_to(jnp.asarray(tex[0, 0]), albedo.shape)
        else:
            color = sample_bilinear(tex, uv_px)
        albedo = jnp.where(mask[..., None], color, albedo)
    return albedo


def _pack_atlas(part_textures):
    """Shelf-pack per-part textures into ONE [H, W, 12] PACKED atlas (host
    side, trace-time constant): each texel row carries its own color plus
    the +x, +y and +x+y neighbors (wrapped within the part, so repeat-wrap
    bilinear stays exact at part edges). One gather then fetches all four
    bilinear taps instead of four. Unlike a pad-to-max stack, memory is the
    sum of texture areas (+shelf slack).

    Returns (atlas [H,W,12] f32, offsets [P,2] (y,x), sizes [P,2] (h,w))."""
    import numpy as np
    pn = len(part_textures)
    sizes = np.array([(t.shape[0], t.shape[1]) for t in part_textures],
                     np.int64)
    atlas_w = max(int(sizes[:, 1].max()), 1)
    order = np.argsort(-sizes[:, 0], kind="stable")  # tall shelves first
    offsets = np.zeros((pn, 2), np.int64)
    shelf_y, shelf_h, x = 0, 0, 0
    for p in order:
        h, w = int(sizes[p, 0]), int(sizes[p, 1])
        if x + w > atlas_w:
            shelf_y += shelf_h
            x, shelf_h = 0, 0
        offsets[p] = (shelf_y, x)
        x += w
        shelf_h = max(shelf_h, h)
    atlas = np.zeros((shelf_y + shelf_h, atlas_w, 12), np.float32)
    for p, t in enumerate(part_textures):
        y0, x0 = offsets[p]
        t3 = np.asarray(t[..., :3], np.float32)
        xr = np.roll(t3, -1, 1)          # +x neighbor, wrapped in-part
        yr = np.roll(t3, -1, 0)          # +y
        xyr = np.roll(xr, -1, 0)         # +x+y
        atlas[y0:y0 + t.shape[0], x0:x0 + t.shape[1]] = np.concatenate(
            [t3, xr, yr, xyr], -1)
    return atlas, offsets.astype(np.float32), sizes.astype(np.float32)


@pytree.dataclass
class PackedAtlas:
    """Device form of the shelf-packed texture atlas.

    This is a PYTREE meant to ride through `jit` as an ARGUMENT: a 16-part
    2048^2 texture set packs to hundreds of MB, and baking that into the
    traced program as a constant bloats every lowering. `data` is
    [H,W,4] uint32 (bit-packed RGB888 2x2 neighborhoods) when every source
    texel sits on the 8-bit grid, else [H,W,12] float32."""
    data: jnp.ndarray
    offsets: jnp.ndarray      # [P,2] i32 (y,x) atlas placement
    sizes: jnp.ndarray        # [P,2] f32 (h,w) per part
    eight_bit: bool = pytree.field(static=True, default=True)
    # mip chain (RenderConfig.texture_mips > 1): every level of every part
    # is shelf-packed into the SAME atlas; these tables address them
    mip_offsets: jnp.ndarray | None = None   # [P,L,2] i32 (y,x)
    mip_sizes: jnp.ndarray | None = None     # [P,L,2] f32 (h,w)
    n_mips: int = pytree.field(static=True, default=0)
    # static (hashable) copy of the mip tables — (oy, ox, h, w) per
    # (part, level) — so resident-slot slice starts and fit levels are
    # compile-time data (build_resident_atlas)
    mip_meta: tuple = pytree.field(static=True, default=())


def _downsample2(t):
    """One mip step: 2x2 box filter (odd trailing row/col dropped), never
    below 1 texel per axis."""
    import numpy as np
    h, w = t.shape[:2]
    if h > 1:
        t = 0.5 * (t[0:2 * (h // 2):2] + t[1:2 * (h // 2):2])
    if w > 1:
        t = 0.5 * (t[:, 0:2 * (w // 2):2] + t[:, 1:2 * (w // 2):2])
    return t


def build_packed_atlas(part_textures, mip_levels: int = 0) \
        -> "PackedAtlas | None":
    """Host-side packing -> PackedAtlas (None when every part is a flat
    1x1 color, which keeps the gather-free broadcast path).

    mip_levels > 1 packs a box-filtered mip chain of every part into the
    same shelf atlas (+~33% texels) for per-triangle level selection in
    affine_uv_part_rows; 8-bit sources keep their levels quantized to the
    8-bit grid so the u32 bit-packing stays exact."""
    import numpy as np
    if part_textures is None or not any(
            t.shape[0] > 1 or t.shape[1] > 1 for t in part_textures):
        return None
    pn = len(part_textures)
    entries = [np.asarray(t, np.float32) for t in part_textures]
    src8 = all(
        np.abs(e * 255.0 - np.round(e * 255.0)).max() < 1e-3
        for e in entries)
    mip_index = None
    if mip_levels and int(mip_levels) > 1:
        L = int(mip_levels)
        mip_index = np.zeros((pn, L), np.int64)
        for p in range(pn):
            mip_index[p, 0] = p
            cur = entries[p]
            for lv in range(1, L):
                if cur.shape[0] > 1 or cur.shape[1] > 1:
                    cur = _downsample2(cur)
                    if src8:
                        cur = np.round(cur * 255.0) / 255.0
                    entries.append(cur)
                    mip_index[p, lv] = len(entries) - 1
                else:
                    mip_index[p, lv] = mip_index[p, lv - 1]
    atlas, offsets, sizes = _pack_atlas(entries)
    scaled = atlas * 255.0
    eight_bit = bool(np.abs(scaled - np.round(scaled)).max() < 1e-3)
    if eight_bit:
        q8 = np.clip(scaled + 0.5, 0, 255).astype(np.uint32)
        data = (q8[..., 0::3] | (q8[..., 1::3] << 8)
                | (q8[..., 2::3] << 16))             # [H,W,4] u32
    else:
        data = atlas                                  # [H,W,12] f32
    mo = ms = None
    meta = ()
    if mip_index is not None:
        mo = jnp.asarray(offsets[mip_index].astype(np.int32))   # [P,L,2]
        ms = jnp.asarray(sizes[mip_index])                      # [P,L,2]
        oi = offsets[mip_index].astype(np.int64)                # [P,L,2]
        si = sizes[mip_index].astype(np.int64)
        meta = tuple(tuple((int(oi[p, l, 0]), int(oi[p, l, 1]),
                            int(si[p, l, 0]), int(si[p, l, 1]))
                           for l in range(oi.shape[1]))
                     for p in range(pn))
    return PackedAtlas(data=jnp.asarray(data),
                       offsets=jnp.asarray(offsets[:pn].astype(np.int32)),
                       sizes=jnp.asarray(sizes[:pn]),
                       eight_bit=eight_bit,
                       mip_offsets=mo, mip_sizes=ms,
                       n_mips=int(mip_levels) if mip_index is not None
                       else 0, mip_meta=meta)


def _albedo_atlas(static, tri, uv_px, part_textures, atlas=None):
    """Single-pass atlas sampling: all parts' textures shelf-packed into one
    neighborhood-packed atlas, per-pixel part id from the triangle id, full
    bilinear filtering from ONE gather per pixel. For 8-bit-exact sources
    (every texture decoded from an image file) the 2x2 neighborhood is
    bit-packed as 4 RGB888 u32 lanes (16 bytes/row) and quantization is
    exact. Float sources that do not sit on the 8-bit grid (procedural
    textures) instead gather f32x12 rows — ~3x the row bytes but bit-exact
    bilinear (a u32 atlas would silently quantize them).

    Pass `atlas` (PackedAtlas, e.g. through jit arguments) for large
    texture sets; built inline from `part_textures` when omitted."""
    import numpy as np
    pn = len(part_textures)
    if atlas is None:
        atlas = build_packed_atlas(part_textures)
    atlas_w = atlas.data.shape[1]

    # part id per pixel: first part whose range contains the triangle id
    bounds = np.asarray(static.part_base, np.int32)
    cov = tri >= 0
    tri = jnp.maximum(tri, 0)
    pid = jnp.clip(jnp.searchsorted(jnp.asarray(bounds), tri, side="right")
                   - 1, 0, pn - 1)

    th = atlas.sizes[:, 0][pid]
    tw = atlas.sizes[:, 1][pid]
    oy = atlas.offsets[:, 0][pid]
    ox = atlas.offsets[:, 1][pid]
    u = uv_px[..., 0] * tw - 0.5
    v = uv_px[..., 1] * th - 0.5
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)

    # repeat wrap within the part's own extent, then shift into the atlas
    xm = jnp.mod(x0, jnp.maximum(tw.astype(jnp.int32), 1)) + ox
    ym = jnp.mod(y0, jnp.maximum(th.astype(jnp.int32), 1)) + oy
    # uncovered pixels are masked downstream: pin their gather address
    # (keeps the DRAM page footprint proportional to covered pixels)
    xm = jnp.where(cov, xm, 0)
    ym = jnp.where(cov, ym, 0)

    return _atlas_bilinear(atlas, xm, ym, fx, fy)


def _atlas_bilinear(atlas, xm, ym, fx, fy):
    """Bilinear filter from the neighborhood-packed atlas: ONE gather per
    pixel (the texel's 2x2 neighborhood rides its row), then 3 lerps."""
    atlas_w = atlas.data.shape[1]
    if atlas.eight_bit:
        flat = atlas.data.reshape(-1, 4)
        q = flat[ym * atlas_w + xm]      # [.., 4] u32 = c00 c10 c01 c11

        def corner(i):
            w = q[..., i]
            return jnp.stack([w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF],
                             -1).astype(jnp.float32) * (1.0 / 255.0)
    else:
        flat = atlas.data.reshape(-1, 12)
        q = flat[ym * atlas_w + xm]      # [.., 12] f32

        def corner(i):
            return q[..., 3 * i:3 * i + 3]
    top = corner(0) * (1 - fx) + corner(1) * fx
    bot = corner(2) * (1 - fx) + corner(3) * fx
    return top * (1 - fy) + bot * fy


def resident_slot_size(n_parts, budget_bytes=20 << 20):
    """Slot edge (multiple of 128, 128..512) that fits the resident
    mini-atlas of `n_parts` parts into `budget_bytes` at 16 B/texel (u32x4
    rows). On the GPU a ~20 MB table sits inside the 50 MB L2; whether the
    copy pays for itself there is an open measurement
    (scripts/bench_atlas16.py)."""
    import math
    s = int(math.sqrt(budget_bytes / (16.0 * max(n_parts, 1)))) // 128 * 128
    return max(min(s, 512), 128)


def resident_fit_levels(atlas, slot):
    """[P] i32: each part's first mip level that fits a slot x slot window,
    or None when some part's chain never fits (texture_mips too shallow
    for this slot). Static — computed from the atlas layout."""
    import numpy as np
    metas = np.asarray(atlas.mip_meta, np.int64)      # [P,L,4] oy,ox,h,w
    L = atlas.n_mips
    fit = []
    for p in range(metas.shape[0]):
        f = next((lv for lv in range(L)
                  if metas[p, lv, 2] <= slot and metas[p, lv, 3] <= slot),
                 None)
        if f is None:
            return None
        fit.append(f)
    return np.asarray(fit, np.int32)


def build_resident_atlas(atlas, need_level, slot):
    """Per-frame resident mip atlas: copy, for each part, ONE level — the
    most detailed level any of its triangles needs this frame
    (`need_level` [P] i32, from _tri_mip_levels + segment_min), clamped to
    the first level that fits a slot x slot window — out of the big mip
    atlas into a fixed [P*slot, slot, lanes] mini table. The albedo
    gather then reads a small table (resident_slot_size) instead of the
    whole mip atlas. The copies are P static-size dynamic_slices
    (~P*slot^2*16 B).

    Clamped slice starts keep the window in-bounds without padding the
    big atlas; the residual (start - clamped) rides into the per-part
    offsets so addressing stays exact.

    Returns (mini PackedAtlas, off_xy [P,2] f32 (x,y) part origins inside
    the mini table, sz_hw [P,2] f32 resident level sizes)."""
    import numpy as np
    P = len(atlas.mip_meta)
    L = atlas.n_mips
    data = atlas.data
    hd, wd, lanes = data.shape
    slot = min(int(slot), hd, wd)   # small atlases: window within bounds
    metas = np.asarray(atlas.mip_meta, np.int64)      # [P,L,4] oy,ox,h,w
    fit = resident_fit_levels(atlas, slot)
    if fit is None:
        raise ValueError(
            f"texture_resident: some parts have no mip level that fits "
            f"the {slot}px resident slot — raise RenderConfig.texture_mips "
            f"so every part's chain reaches <= {slot}px (largest texture "
            f"{int(metas[:, 0, 2:].max())}px needs "
            f">= {int(np.ceil(np.log2(metas[:, 0, 2:].max() / slot))) + 1} "
            f"levels)")
    slices, offs, szs = [], [], []
    for p in range(P):
        rl = jnp.clip(jnp.maximum(need_level[p], fit[p]), 0, L - 1)
        m = jnp.asarray(metas[p].astype(np.int32))    # [L,4] tiny constant
        oy, ox, hh, ww = m[rl, 0], m[rl, 1], m[rl, 2], m[rl, 3]
        cy = jnp.clip(oy, 0, hd - slot)
        cx = jnp.clip(ox, 0, wd - slot)
        slices.append(jax.lax.dynamic_slice(
            data, (cy, cx, jnp.int32(0)), (slot, slot, lanes)))
        offs.append(jnp.stack([ox - cx, p * slot + (oy - cy)]))   # (x, y)
        szs.append(jnp.stack([hh, ww]))
    mini = jnp.concatenate(slices, axis=0)            # [P*slot, slot, ln]
    mini_atlas = PackedAtlas(data=mini, offsets=atlas.offsets,
                             sizes=atlas.sizes, eight_bit=atlas.eight_bit)
    return (mini_atlas, jnp.stack(offs).astype(jnp.float32),
            jnp.stack(szs).astype(jnp.float32))


def _window_ladder(full, unit, fracs=(0.15, 0.27, 0.40, 0.55, 0.75)):
    """Static ladder of window sizes (multiples of `unit`, ending at full).
    All sizes live in ONE program (lax.switch branches), so a finer ladder
    costs compile time, not runtime — and cuts window slack: the albedo
    pass scales with window pixels."""
    out = []
    for f in fracs:
        s = min(-(-int(full * f) // unit) * unit, full)
        if s < full and s not in out:
            out.append(s)
    out.append(full)
    return out


def affine_uv_rows(uvs, tris):
    """Per-triangle affine UV plane rows [T, 8]: (u0, v0, du1, dv1, du2,
    dv2, 0, 0) — uv(pixel) = (u0, v0) + b1*(du1, dv1) + b2*(du2, dv2) from
    the visibility buffer's screen barycentrics. See uv_from_vis."""
    g = jnp.asarray(uvs)[tris]                        # [T,3,2]
    u0 = g[:, 0]
    d1 = g[:, 1] - g[:, 0]
    d2 = g[:, 2] - g[:, 0]
    pad = jnp.zeros((tris.shape[0], 2), jnp.float32)
    return jnp.concatenate([u0, d1, d2, pad], -1)


def _tri_mip_levels(g, sz0, screen_xy, tris, L):
    """Per-triangle mip level [T] from the UV-area / screen-area ratio
    (isotropic sqrt(texels-per-pixel)): g [T,3,2] UVs, sz0 [T,2] level-0
    (w,h) texels, screen_xy [V,2] pixel positions."""
    d1t = (g[:, 1] - g[:, 0]) * sz0
    d2t = (g[:, 2] - g[:, 0]) * sz0
    s = screen_xy[tris]                               # [T,3,2] px
    e1 = s[:, 1] - s[:, 0]
    e2 = s[:, 2] - s[:, 0]
    area_px = jnp.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    area_tx = jnp.abs(d1t[:, 0] * d2t[:, 1] - d1t[:, 1] * d2t[:, 0])
    rho2 = area_tx / jnp.maximum(area_px, 1e-12)
    lvl = jnp.clip(jnp.floor(0.5 * jnp.log2(jnp.maximum(rho2, 1e-20))),
                   0, L - 1).astype(jnp.int32)
    # degenerate screen triangles (<= a pixel) take the smallest level
    return jnp.where(area_px < 1e-9, L - 1, lvl)


def _static_pid(tris_n, static, pn):
    """[T] part id per triangle — STATIC (parts are contiguous triangle
    ranges, reader/pmx_reader_impl.inl:185-189)."""
    import numpy as np
    bounds = np.asarray(static.part_base, np.int32)
    return np.clip(np.searchsorted(bounds, np.arange(tris_n),
                                   side="right") - 1, 0, pn - 1)


def affine_uv_part_rows(uvs, tris, atlas, static, screen_xy=None,
                        resident=None):
    """[T, 12] texel-space affine UV rows with each triangle's atlas
    placement baked in: (u0, v0, du1, dv1, du2, dv2, ox, oy, tw, th, 0, 0),
    all in atlas texels. The triangle->part mapping is STATIC (parts are
    contiguous triangle ranges, reader/pmx_reader_impl.inl:185-189), so the
    per-part atlas offset/size tables are gathered once per FRAME at [T]
    granularity here — not once per PIXEL in the sampler. With more than a
    handful of parts XLA lowers per-pixel `table[pid]` indexing to real
    gathers: a 16-part split measured +3.3 ms/frame at 1080p (4 table
    gathers + a searchsorted per pixel); this folds all of it into the one
    row gather the deferred-UV path already does (32 -> 48 byte rows).

    With `screen_xy` ([V,2] pixel positions) and a mip-chain atlas
    (n_mips > 1), each triangle's mip LEVEL is selected here too — from the
    ratio of its UV-space to screen-space area (the isotropic sqrt(texels
    per pixel) estimate every GPU uses) — and the row's offset/size/UV
    scale address that level's region of the atlas. The per-pixel sampler
    is untouched: same row format, same single gather, but minified parts'
    gathers land in a 4^level-smaller region (DRAM page locality), and
    minification is box-filtered instead of aliased.

    With `resident` = (off_xy [P,2] f32 (x,y), sz_hw [P,2] f32) from
    build_resident_atlas, rows instead address each part's slot in the
    per-frame resident mini-atlas (one level per part)."""
    g = jnp.asarray(uvs)[tris]                        # [T,3,2]
    pid_np = _static_pid(tris.shape[0], static, atlas.sizes.shape[0])
    pid = jnp.asarray(pid_np)
    d1u = g[:, 1] - g[:, 0]
    d2u = g[:, 2] - g[:, 0]
    if resident is not None:
        roff, rsz = resident
        off_xy = roff[pid].astype(jnp.float32)        # [T,2] (x,y)
        sz_wh = rsz[pid][:, ::-1].astype(jnp.float32)  # (w,h)
    elif atlas.n_mips > 1 and screen_xy is not None:
        L = atlas.n_mips
        sz0 = atlas.sizes[pid][:, ::-1]               # [T,2] (w,h) level 0
        lvl = _tri_mip_levels(g, sz0, screen_xy, tris, L)
        idx = pid * L + lvl                           # [T] traced
        off_xy = atlas.mip_offsets.reshape(-1, 2)[idx][:, ::-1] \
            .astype(jnp.float32)
        sz_wh = atlas.mip_sizes.reshape(-1, 2)[idx][:, ::-1]
    else:
        sz_wh = atlas.sizes[pid][:, ::-1]             # [T,2] f32 (w,h)
        off_xy = atlas.offsets[pid][:, ::-1].astype(jnp.float32)
    u0 = g[:, 0] * sz_wh
    d1 = d1u * sz_wh
    d2 = d2u * sz_wh
    pad = jnp.zeros((tris.shape[0], 2), jnp.float32)
    return jnp.concatenate([u0, d1, d2, off_xy, sz_wh, pad], -1)


def _albedo_rows(atlas, tri, bary, rows):
    """Deferred-UV atlas sampling from fused rows (affine_uv_part_rows):
    one 48-byte row gather + one atlas gather per pixel, no per-pixel part
    tables at all. Pixels with no character coverage (tri < 0 — roughly
    half of a bbox window) are masked downstream, so their gather address
    is pinned to texel 0: a uniform address per idle lane instead of a
    scattered one keeps the gather's DRAM page footprint proportional to
    COVERED pixels."""
    cov = tri >= 0
    r = rows[jnp.maximum(tri, 0)]                     # [.., 12] gather
    b1 = bary[..., 0]
    b2 = bary[..., 1]
    u = r[..., 0] + b1 * r[..., 2] + b2 * r[..., 4] - 0.5
    v = r[..., 1] + b1 * r[..., 3] + b2 * r[..., 5] - 0.5
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    tw = jnp.maximum(r[..., 8].astype(jnp.int32), 1)
    th = jnp.maximum(r[..., 9].astype(jnp.int32), 1)
    xm = jnp.mod(x0.astype(jnp.int32), tw) + r[..., 6].astype(jnp.int32)
    ym = jnp.mod(y0.astype(jnp.int32), th) + r[..., 7].astype(jnp.int32)
    xm = jnp.where(cov, xm, 0)
    ym = jnp.where(cov, ym, 0)
    return _atlas_bilinear(atlas, xm, ym, fx, fy)


def uv_from_vis(tri, bary, uv_rows):
    """Reconstruct per-pixel UVs from the visibility buffer: one 32-byte row
    gather per pixel instead of riding 2 attribute channels through the
    raster kernel (each channel costs 3 plane coefficients per binned entry
    and a per-entry plane evaluation for every pixel of its tile).
    Interpolation is AFFINE in screen space —
    exact to well under a texel for character-scale triangles (~16 px); the
    perspective deviation only matters for screen-filling triangles, which
    the big-tri fallback rasterizes separately anyway."""
    r = uv_rows[jnp.maximum(tri, 0)]                  # [.., 8] gather
    b1 = bary[..., 0]
    b2 = bary[..., 1]
    return jnp.stack([r[..., 0] + b1 * r[..., 2] + b2 * r[..., 4],
                      r[..., 1] + b1 * r[..., 3] + b2 * r[..., 5]], -1)


def character_albedo_windowed(static, tri, uv_px, part_textures,
                              atlas=None, bary=None, uv_rows=None):
    """character_albedo restricted to the character's screen bounding box.

    The texture pass scales with the number of pixels it samples, and at
    1080p the character typically covers <15% of the frame. The bbox comes
    from the visibility buffer (two cheap any-reductions), the window size
    from a small static ladder via lax.switch — shapes stay static under
    jit; window origins are aligned to 128 columns and 8 rows.
    Pixels outside the bbox have no character coverage, so white albedo
    there is exact (they are masked by char_mask downstream): the result is
    bit-identical to the full-frame path wherever it is consumed.

    With `bary` + `uv_rows`, per-pixel UVs are reconstructed inside the
    window and `uv_px` may be None — the raster kernel then carries no UV
    channels at all. 12-column rows (affine_uv_part_rows) carry the atlas
    placement too and sample via _albedo_rows (no per-pixel part tables);
    8-column rows (affine_uv_rows) reconstruct plain UVs (uv_from_vis)."""
    h, w = tri.shape
    fused = (uv_rows is not None and atlas is not None
             and uv_rows.shape[-1] == 12)

    def sample(tri_w, bary_w, uv_w):
        if fused:
            return _albedo_rows(atlas, tri_w, bary_w, uv_rows)
        if uv_rows is not None:
            uv_w = uv_from_vis(tri_w, bary_w, uv_rows)
        return character_albedo(static, tri_w, uv_w, part_textures, atlas)

    ws = _window_ladder(w, 128)
    hs = _window_ladder(h, 8)
    if h * w < 512 * 512 or (len(ws) == 1 and len(hs) == 1):
        # small frames: the switch costs more than it saves
        return sample(tri, bary, uv_px)

    cov = tri >= 0
    cov_x = jnp.any(cov, axis=0)
    cov_y = jnp.any(cov, axis=1)
    x0 = (jnp.argmax(cov_x).astype(jnp.int32) // 128) * 128
    x1 = (w - jnp.argmax(cov_x[::-1])).astype(jnp.int32)
    y0 = (jnp.argmax(cov_y).astype(jnp.int32) // 8) * 8
    y1 = (h - jnp.argmax(cov_y[::-1])).astype(jnp.int32)
    # empty coverage -> x1 = w, y1 = h: the largest window runs and is
    # discarded by the coverage mask downstream (rare; exactness first)
    need_w = x1 - x0
    need_h = y1 - y0
    iw = sum((need_w > s).astype(jnp.int32) for s in ws[:-1])
    ih = sum((need_h > s).astype(jnp.int32) for s in hs[:-1])

    def make_branch(w_win, h_win):
        def branch(_):
            ox = jnp.clip(x0, 0, w - w_win)
            oy = jnp.clip(y0, 0, h - h_win)
            tri_w = jax.lax.dynamic_slice(tri, (oy, ox), (h_win, w_win))
            b_w = (jax.lax.dynamic_slice(
                bary, (oy, ox, jnp.int32(0)), (h_win, w_win, 2))
                if uv_rows is not None else None)
            uv_w = (jax.lax.dynamic_slice(
                uv_px, (oy, ox, jnp.int32(0)), (h_win, w_win, 2))
                if uv_rows is None else None)
            alb = sample(tri_w, b_w, uv_w)
            full = jnp.ones((h, w, 3), jnp.float32)
            return jax.lax.dynamic_update_slice(
                full, alb, (oy, ox, jnp.int32(0)))
        return branch

    branches = [make_branch(w_win, h_win) for w_win in ws for h_win in hs]
    return jax.lax.switch(iw * len(hs) + ih, branches, 0)


def crowd_render_supported(cfg: RenderConfig, part_textures=None,
                           cubemap=None, camera=None) -> bool:
    """True when the fused multi-instance render path covers the config:
    textures (shared atlas, incl. texture_mips level selection per
    instance), native 4x MSAA, edge outlines (a second fused raster over
    the displaced hull), double-sided materials (shared nocull mask),
    skybox (camera-shared — one cube-sample pass for all instances),
    MMD toon/sphere shading (vmapped per-pixel stage over the fused
    buffers — pass `mmd_maps` to crowd_render_frame), shadows and ground
    are all fused; per-instance VMD camera, the supersample-emulation
    MSAA and the scan raster fall back to vmap(render_frame), which
    supports them. `texture_resident` (a single-instance perf knob: the
    per-frame resident mip mini-atlas) is intentionally ignored on the
    crowd path — the fused path samples the mip atlas directly, which is
    exact; a per-instance mini-atlas would multiply the copy cost by I."""
    return (camera is None
            and not (cfg.msaa >= 4 and cfg.msaa_supersample)
            and _pick_raster(cfg) is not raster.rasterize)


@f32_matmul
def crowd_render_frame(static, positions_mmd, normals, cfg: RenderConfig,
                       width=None, height=None, part_textures=None,
                       atlas=None, cubemap=None, mmd_maps=None,
                       uv_offsets=None, part_color=None):
    """Fused multi-instance frame: positions/normals carry a leading
    instance axis; ONE binning sort and ONE kernel launch cover all
    instances' character and shadow rasters (ops/tiled_raster crowd path).
    vmapping render_frame instead pays per-instance fixed costs (batched
    small sorts, tiny kernel grids) that dominate at crowd viewport sizes.
    Camera-shared work (ground geometry, ray grid) is computed once and
    broadcast. Per-part textures sample through the shared shelf-packed
    atlas per instance; cfg.msaa >= 4 runs the fused per-sample MSAA
    kernel. -> [I, H, W, 3]."""
    from ..ops.tiled_raster import (rasterize_attrs_tiled_crowd,
                                    rasterize_attrs_tiled_msaa_crowd,
                                    rasterize_depth_tiled_crowd)
    width = width or cfg.width
    height = height or cfg.height
    n_inst = positions_mmd.shape[0]
    mats = build_matrices(cfg, None, aspect=width / height)
    verts_m = positions_mmd * cfg.mmd_to_meter
    tris = jnp.asarray(static.triangles)[:, ::-1]

    # per-corner vertex tables shared by the crowd shadow AND character
    # rasters: ONE [I*T*3]-row gather of [pos | attrs], transformed per
    # pass (same trick as render_frame; per-instance row gathers are the
    # fused setup's dominant cost and used to run once per pass)
    attr_list = [jnp.asarray(normals)]
    if part_textures is not None:
        # per-instance UV morphs (extended morphs) simply ride the
        # instance axis the attrs already carry
        uvs_b = (jnp.asarray(static.uvs)[None] + uv_offsets
                 if uv_offsets is not None
                 else jnp.broadcast_to(jnp.asarray(static.uvs)[None],
                                       (n_inst,) + static.uvs.shape))
        attr_list.append(uvs_b)
    attrs = (jnp.concatenate(attr_list, -1) if len(attr_list) > 1
             else attr_list[0])
    g3 = jax.vmap(
        lambda w, a: jnp.concatenate([w, a], -1)[tris])(verts_m, attrs)
    corner_pos, corner_va = g3[..., :3], g3[..., 3:]

    # --- shadow maps (per instance, one fused launch)
    if cfg.shadows_enabled:
        sclip = jax.vmap(
            lambda v: raster.transform_clip(v, mats["light_mvp"]))(verts_m)
        scv = jax.vmap(
            lambda c: raster.transform_clip(c, mats["light_mvp"]))(
                corner_pos)
        shadow_maps = rasterize_depth_tiled_crowd(
            sclip, tris, cfg.shadow_map_size, cfg.shadow_map_size,
            raster.CULL_FRONT, cv=scv)

    # --- background + ground: camera-shared, computed once
    color1 = jnp.broadcast_to(jnp.asarray(cfg.clear_color, jnp.float32),
                              (height, width, 3))
    if cfg.show_skybox and cubemap is not None:
        # the skybox is pure camera geometry — ONE cube sample pass shared
        # by every instance (the vmap fallback paid it per instance)
        color1 = ibl_mod.skybox_colors(cubemap, mats["view"], mats["proj"],
                                       width, height)
    if cfg.show_ground:
        ground_mask, gpos, ground_depth = ground_pass(
            cfg, mats["view"], mats["proj"], width, height)
        if cfg.shadows_enabled:
            ds = max(int(cfg.shadow_lookup_downsample), 1)
            lo_res = ds > 1 and width % ds == 0 and height % ds == 0
            if lo_res:
                # geometric halo rows for the upsample (see render_frame)
                lw, lh = width // ds, height // ds
                _, gpos_l, _ = ground_pass(cfg, mats["view"], mats["proj"],
                                           lw, lh, row0=-1, rows=lh + 2)
                lclip = raster.transform_clip(
                    gpos_l.reshape(-1, 3), mats["light_vp"]).reshape(
                        lh + 2, lw, 4)
            else:
                lw, lh = width, height
                lclip = raster.transform_clip(
                    gpos.reshape(-1, 3), mats["light_vp"]).reshape(
                        lh, lw, 4)

            # lit maps for ALL instances in one batched pass
            lms = shade.ground_lit_map(shadow_maps, mats["light_vp"])

            def lit_one(lm):
                lo = shade.ground_shadow_lookup(lclip, lm, jnp.asarray(True))
                if lo_res:
                    lo = upsample_bilinear_int(lo, ds, pre_padded_rows=True)
                return lo

            lit = jax.vmap(lit_one)(lms)                      # [I,H,W,1]
        else:
            lit = jnp.ones((n_inst, height, width, 1), jnp.float32)
        gcolor = jnp.ones(3, jnp.float32) * 0.7 * lit
        color = jnp.where(ground_mask[None, ..., None], gcolor,
                          color1[None])
    else:
        ground_depth = jnp.ones((height, width), jnp.float32)
        color = jnp.broadcast_to(color1[None],
                                 (n_inst, height, width, 3))

    # --- character (fused raster + shared-camera unproject; attrs and the
    # corner tables were built above, before the shadow pass)
    clip = jax.vmap(lambda v: raster.transform_clip(v, mats["mvp"]))(verts_m)
    ccv = jax.vmap(
        lambda c: raster.transform_clip(c, mats["mvp"]))(corner_pos)
    # double-sided materials: same static [T] cull exemption as
    # render_frame, shared across instances like the topology
    nocull = None
    if cfg.double_sided and static.nocull_tris.any():
        nocull = jnp.asarray(static.nocull_tris)
    sdepth = None
    if cfg.msaa >= 4:
        vis, attr_px, sdepth = rasterize_attrs_tiled_msaa_crowd(
            clip, tris, attrs, width, height, raster.CULL_BACK,
            cv=ccv, va=corner_va, nocull=nocull)
    else:
        vis, attr_px = rasterize_attrs_tiled_crowd(
            clip, tris, attrs, width, height, raster.CULL_BACK,
            cv=ccv, va=corner_va, nocull=nocull)
    char_mask = (vis.tri >= 0) & (vis.depth <= ground_depth[None])

    # edge outlines (as in render_frame): inverted hull displaced along
    # deformed normals, front-cull, fused across instances — one more
    # crowd raster over the MAT_DRAW_EDGE subset, no vmap fallback needed
    edge_mask = None
    if cfg.show_edges and len(static.edge_tris):
        emag = (jnp.asarray(static.edge_mag)
                * (0.01 * cfg.edge_scale))[:, None]
        verts_e = (positions_mmd + jnp.asarray(normals) * emag) \
            * cfg.mmd_to_meter
        etris = jnp.asarray(static.edge_tris)[:, ::-1]
        clip_e = jax.vmap(
            lambda v: raster.transform_clip(v, mats["mvp"]))(verts_e)
        vis_e, _ = rasterize_attrs_tiled_crowd(
            clip_e, etris,
            jnp.zeros(positions_mmd.shape[:2] + (1,), jnp.float32),
            width, height, raster.CULL_FRONT)
        pid_e = jnp.asarray(static.edge_tri_part)[jnp.maximum(vis_e.tri, 0)]
        edge_color_px = jnp.asarray(static.edge_colors)[pid_e][..., :3]
        edge_mask = (vis_e.tri >= 0) & (vis_e.depth <= ground_depth[None])
    vp = mats["proj"] @ mats["view"]
    world_px = jax.vmap(
        lambda d: unproject_depth(d, vp, width, height))(vis.depth)
    if part_textures is not None:
        atl = atlas
        if atl is not None and atl.n_mips > 1:
            # mip-chain atlas: per-instance fused UV/placement rows select
            # each triangle's mip level from ITS instance's screen-space
            # footprint (same _tri_mip_levels selection as the
            # single-instance deferred-UV path), sampled via _albedo_rows —
            # one extra [T,12] row table per instance, no per-pixel part
            # tables. texture_resident stays single-instance-only: a
            # per-frame resident mini-atlas PER INSTANCE would multiply
            # the copy cost by I (crowd_render_frame ignores it; sampling
            # the mip atlas directly is exact).
            uvs0 = jnp.asarray(static.uvs)
            uvs_i = (uvs0[None] + uv_offsets if uv_offsets is not None
                     else jnp.broadcast_to(uvs0[None],
                                           (n_inst,) + uvs0.shape))

            def albedo_one(c, t, b, u):
                screen, _, _ = raster.screen_from_clip(c, width, height)
                rows = affine_uv_part_rows(u, tris, atl, static,
                                           screen_xy=screen)
                return _albedo_rows(atl, t, b, rows)

            albedo = jax.vmap(albedo_one)(clip, vis.tri, vis.bary, uvs_i)
        else:
            albedo = jax.vmap(
                lambda t, uv: character_albedo(static, t, uv, part_textures,
                                               atlas))(
                    vis.tri, attr_px[..., 3:5])
    else:
        albedo = jnp.ones((n_inst, height, width, 3), jnp.float32)
    if part_color is not None:
        # material-morph albedo modulation, per instance (extended morphs)
        import numpy as _np
        mm_mul, mm_add = part_color                        # [I,P,3] each
        pbounds = jnp.asarray(_np.asarray(static.part_base, _np.int32))
        pcount = len(static.part_base)

        def pc_one(alb, tri, mul, add):
            pid = jnp.clip(jnp.searchsorted(pbounds, jnp.maximum(tri, 0),
                                            side="right") - 1,
                           0, pcount - 1)
            return jnp.clip(alb * mul[pid] + add[pid], 0.0, None)

        albedo = jax.vmap(pc_one)(albedo, vis.tri, mm_mul, mm_add)
    nrm_px = attr_px[..., 0:3]
    if nocull is not None:
        # two-sided lighting (as in render_frame): back faces of
        # double-sided surfaces shade with the viewer-facing normal
        to_eye = jnp.asarray(cfg.camera_pos, jnp.float32) - world_px
        flip = jnp.sum(nrm_px * to_eye, -1, keepdims=True) < 0.0
        nrm_px = jnp.where(flip, -nrm_px, nrm_px)
    sphere_addend = None
    if mmd_maps is not None:
        # MMD extended shading (toon ramps + SPH/SPA sphere maps), same
        # per-pixel math as render_frame, vmapped over the fused raster's
        # per-instance buffers; the static tables (ramps, sphere atlas,
        # part bounds) are shared across instances
        import numpy as _np
        sphere_texs, sphere_modes, toon_ramps = mmd_maps
        bounds = jnp.asarray(_np.asarray(static.part_base, _np.int32))
        npart = len(static.part_base)
        ldir = jnp.asarray(cfg.light_direction, jnp.float32)
        ldir = ldir / jnp.linalg.norm(ldir)
        k = toon_ramps.shape[1]
        ramp_flat = jnp.asarray(toon_ramps.reshape(-1, 3))
        any_sphere = any(m != 0 for m in _np.asarray(sphere_modes))
        modes_arr = jnp.asarray(_np.asarray(sphere_modes))
        view_rot = mats["view"][:3, :3]

        def mmd_one(alb, nrm, tri):
            pid = jnp.clip(jnp.searchsorted(bounds, jnp.maximum(tri, 0),
                                            side="right") - 1,
                           0, npart - 1)
            ndl = -jnp.sum(nrm * ldir, -1)
            qi = jnp.clip(jnp.round((0.5 - 0.5 * ndl) * (k - 1)),
                          0, k - 1).astype(jnp.int32)
            alb = alb * ramp_flat[pid * k + qi]
            addend = jnp.zeros_like(alb)
            if any_sphere:
                nv = nrm @ view_rot.T
                uv_s = jnp.stack([nv[..., 0] * 0.5 + 0.5,
                                  0.5 - nv[..., 1] * 0.5], -1)
                scol = character_albedo(static, tri, uv_s, sphere_texs)
                modes_px = modes_arr[pid]
                alb = jnp.where((modes_px == 1)[..., None], alb * scol,
                                alb)
                addend = jnp.where((modes_px == 2)[..., None], scol, 0.0)
            return alb, addend

        albedo, sphere_addend = jax.vmap(mmd_one)(albedo, nrm_px, vis.tri)
    char_color = jax.vmap(
        lambda a, n, wp: shade.shade_character(
            a, n, wp, jnp.asarray(cfg.camera_pos, jnp.float32), cfg))(
                albedo, nrm_px, world_px)
    if sphere_addend is not None:
        char_color = char_color + sphere_addend
    if edge_mask is not None:
        # outlines sit between background/ground and the character
        color = jnp.where((edge_mask & ~char_mask)[..., None],
                          edge_color_px, color)
    if sdepth is not None:
        # MSAA resolve (as in render_frame): shade once per pixel, coverage
        # from the 4 per-sample depths vs the shared ground depth
        mask_s = (sdepth < 1.0 - 1e-7) & (sdepth <= ground_depth[None, None])
        frac = jnp.mean(mask_s.astype(jnp.float32), axis=1)[..., None]
        color = color * (1.0 - frac) + char_color * frac
    else:
        color = jnp.where(char_mask[..., None], char_color, color)
    return jnp.clip(color, 0.0, 1.0)


@f32_matmul
def render_frame(static, positions_mmd, normals, cfg: RenderConfig,
                 part_textures=None, cubemap=None, model_mat=None,
                 width=None, height=None, uv_offsets=None, part_color=None,
                 mmd_maps=None, atlas=None, proj_transform=None,
                 aspect=None):
    """Full main-pass image, [H,W,3] float32 in [0,1].

    positions_mmd/normals: deformed vertices from core.pose.deform (MMD
    units). cfg.msaa >= 4 renders 2x2 supersampled and box-filters down (the
    reference's 4x MSAA, main.cpp:2504).

    proj_transform: optional 4x4 clip-space window transform (with `aspect`
    pinned to the FULL frame's ratio) — used by parallel.mesh.frame_jit to
    render one horizontal band of the frame per device."""
    width = width or cfg.width
    height = height or cfg.height
    raster_fn = _pick_raster(cfg)
    msaa_native = (cfg.msaa >= 4 and not cfg.msaa_supersample
                   and raster_fn is not raster.rasterize)
    if cfg.msaa >= 4 and not msaa_native:
        import dataclasses
        sub = dataclasses.replace(cfg, msaa=1,
                                  shadow_lookup_downsample=max(
                                      2 * cfg.shadow_lookup_downsample, 2))
        big = render_frame(static, positions_mmd, normals, sub,
                           part_textures=part_textures, cubemap=cubemap,
                           model_mat=model_mat, width=2 * width,
                           height=2 * height, uv_offsets=uv_offsets,
                           part_color=part_color, mmd_maps=mmd_maps,
                           atlas=atlas, proj_transform=proj_transform,
                           aspect=aspect)
        return big.reshape(height, 2, width, 2, 3).mean(axis=(1, 3))
    mats = build_matrices(cfg, model_mat,
                          aspect=width / height if aspect is None else aspect,
                          proj_transform=proj_transform)

    verts_m = positions_mmd * cfg.mmd_to_meter
    tris = jnp.asarray(static.triangles)[:, ::-1]  # winding flip at upload

    # --- per-vertex attribute selection (needed before the shadow pass so
    # its vertex gather can be shared). World position is NOT interpolated:
    # it is reconstructed by unprojecting the depth buffer through
    # inv(proj @ view) — one fixed per-pixel cost instead of three
    # per-entry attribute channels in the raster loop. UV channels ride
    # along only when textures exist.
    attr_list = [jnp.asarray(normals)]
    # deferred UV: with the windowed albedo on the tiled raster, per-pixel
    # UVs are reconstructed from the visibility buffer inside the window
    # (uv_from_vis) instead of riding the kernel as 2 attribute channels
    defer_uv = (part_textures is not None and cfg.albedo_window
                and raster_fn is not raster.rasterize)
    if part_textures is not None:
        uvs = jnp.asarray(static.uvs)
        if uv_offsets is not None:
            # UV morphs (beyond-parity, AppConfig.apply_extended_morphs)
            uvs = uvs + uv_offsets
        if not defer_uv:
            attr_list.append(uvs)
    attrs = jnp.concatenate(attr_list, -1) if len(attr_list) > 1 \
        else attr_list[0]

    # per-corner vertex table shared by the shadow AND character rasters:
    # ONE 3T-row gather of [pos | attrs], transformed per pass (the
    # transform is a tiny matmul; the random row gathers are the setup
    # cost). Bitwise-identical to gathering each pass's clip coords:
    # clip = MVP @ p is the same arithmetic per corner as per vertex.
    corner_pos = corner_va = None
    if raster_fn is not raster.rasterize:
        g3 = jnp.concatenate([verts_m, attrs], -1)[tris]
        corner_pos, corner_va = g3[..., :3], g3[..., 3:]

    # --- shadow pass. pass_scope = the reference's sg_push_debug_group
    # pass labels (main.cpp:2014/2055/2192): each scope names its ops in
    # jax.profiler / xprof traces
    if cfg.shadows_enabled:
        with pass_scope("shadow"):
            shadow_map = shadow_pass(verts_m, tris, mats["light_mvp"],
                                     cfg.shadow_map_size, raster_fn,
                                     compact=cfg.compact_bin,
                                     corner_pos=corner_pos)
    else:
        shadow_map = jnp.ones((1, 1), jnp.float32)

    # --- background: clear color, then skybox (drawn at far depth)
    color = jnp.broadcast_to(jnp.asarray(cfg.clear_color, jnp.float32),
                             (height, width, 3))
    if cfg.show_skybox and cubemap is not None:
        with pass_scope("skybox"):
            color = ibl_mod.skybox_colors(cubemap, mats["view"],
                                          mats["proj"], width, height)

    # --- ground (identity model matrix, main.cpp:2152)
    if cfg.show_ground:
        with pass_scope("ground"):
            ground_mask, gpos, ground_depth = ground_pass(
                cfg, mats["view"], mats["proj"], width, height)
            if cfg.shadows_enabled:
                # 3x3 PCF evaluated in shadow space (one dense pass), then a
                # single lookup per (possibly downsampled) pixel — see
                # shade.ground_lit_map / RenderConfig.shadow_lookup_downsample
                lit_map = shade.ground_lit_map(shadow_map, mats["light_vp"])
                ds = max(int(cfg.shadow_lookup_downsample), 1)
                if ds > 1 and width % ds == 0 and height % ds == 0:
                    # one GEOMETRIC halo row beyond each edge (row0=-1,
                    # rows=lh+2): the upsample blends true neighbor values,
                    # so a row-banded frame (frame_jit) is seamless — each
                    # band's halo rows are the neighbor band's edge rows
                    lw, lh = width // ds, height // ds
                    _, gpos_lo, _ = ground_pass(cfg, mats["view"], mats["proj"],
                                                lw, lh, row0=-1, rows=lh + 2)
                    lclip = raster.transform_clip(
                        gpos_lo.reshape(-1, 3), mats["light_vp"]).reshape(
                            lh + 2, lw, 4)
                    lit_lo = shade.ground_shadow_lookup(lclip, lit_map,
                                                        jnp.asarray(True))
                    lit = upsample_bilinear_int(lit_lo, ds,
                                                pre_padded_rows=True)
                else:
                    lclip = raster.transform_clip(
                        gpos.reshape(-1, 3), mats["light_vp"]).reshape(
                            height, width, 4)
                    lit = shade.ground_shadow_lookup(lclip, lit_map,
                                                     jnp.asarray(True))
            else:
                lit = jnp.ones((height, width, 1), jnp.float32)
            gcolor = jnp.ones(3, jnp.float32) * 0.7 * lit
            color = jnp.where(ground_mask[..., None], gcolor, color)

    else:
        ground_mask = jnp.zeros((height, width), bool)
        ground_depth = jnp.ones((height, width), jnp.float32)

    # --- edge outlines (beyond-parity; RenderConfig.show_edges): inverted
    # hull of the MAT_DRAW_EDGE parts, displaced along deformed normals,
    # front faces culled so only the silhouette ring shows, composited
    # UNDER the character
    edge_mask = None
    if cfg.show_edges and len(static.edge_tris):
        emag = (jnp.asarray(static.edge_mag)
                * (0.01 * cfg.edge_scale))[:, None]
        verts_e = (positions_mmd + jnp.asarray(normals) * emag) \
            * cfg.mmd_to_meter
        etris = jnp.asarray(static.edge_tris)[:, ::-1]
        clip_e = raster.transform_clip(verts_e, mats["mvp"])
        if raster_fn is raster.rasterize:
            vis_e = raster.rasterize(clip_e, etris, width, height,
                                     raster.CULL_FRONT)
        else:
            from ..ops.tiled_raster import rasterize_tiled
            vis_e = rasterize_tiled(clip_e, etris, width, height,
                                    raster.CULL_FRONT,
                                    _tiled_e_max(width, height),
                                    cfg.compact_bin)
        pid_e = jnp.asarray(static.edge_tri_part)[jnp.maximum(vis_e.tri, 0)]
        edge_color_px = jnp.asarray(static.edge_colors)[pid_e][..., :3]
        edge_mask = (vis_e.tri >= 0) & (vis_e.depth <= ground_depth)

    # --- character (attrs selected above, before the shadow pass)
    clip = raster.transform_clip(verts_m, mats["mvp"])
    cv = (raster.transform_clip(corner_pos, mats["mvp"])
          if corner_pos is not None else None)
    # double-sided materials (beyond-parity; the reference's single
    # back-cull pipeline ignores MAT_DOUBLE_FACE): exempt their triangles
    # from face culling
    nocull = None
    if cfg.double_sided and static.nocull_tris.any():
        nocull = jnp.asarray(static.nocull_tris)
    sdepth = None
    with pass_scope("character"):
        if raster_fn is raster.rasterize:
            vis = raster_fn(clip, tris, width, height, raster.CULL_BACK,
                            nocull=nocull)
            attr_px = raster.interpolate(vis, clip, tris, attrs)
        elif msaa_native:
            from ..ops.tiled_raster import rasterize_attrs_tiled_msaa
            vis, attr_px, sdepth = rasterize_attrs_tiled_msaa(
                clip, tris, attrs, width, height, raster.CULL_BACK,
                _tiled_e_max(width, height), nocull, cfg.compact_bin,
                cv=cv, va=corner_va)
        else:
            from ..ops.tiled_raster import rasterize_attrs_tiled
            vis, attr_px = rasterize_attrs_tiled(
                clip, tris, attrs, width, height, raster.CULL_BACK,
                _tiled_e_max(width, height), nocull, cfg.compact_bin,
                cv=cv, va=corner_va)
    char_mask = (vis.tri >= 0) & (vis.depth <= ground_depth)

    world_px = unproject_depth(vis.depth, mats["proj"] @ mats["view"],
                               width, height)
    nrm_px = attr_px[..., 0:3]
    uv_px = (attr_px[..., 3:5]
             if part_textures is not None and not defer_uv else None)
    if model_mat is not None:
        # world_px is already post-model-transform (unprojected from the
        # rendered depth); only normals need the normal-matrix correction
        mm = jnp.asarray(model_mat)
        nmat = jnp.linalg.inv(mm[:3, :3]).T
        nrm_px = nrm_px @ nmat.T
    if nocull is not None:
        # two-sided lighting: back faces of double-sided surfaces shade
        # with the viewer-facing normal
        to_eye = jnp.asarray(cfg.camera_pos, jnp.float32) - world_px
        flip = jnp.sum(nrm_px * to_eye, -1, keepdims=True) < 0.0
        nrm_px = jnp.where(flip, -nrm_px, nrm_px)

    if part_textures is None:
        albedo = jnp.ones((height, width, 3), jnp.float32)
    else:
        with pass_scope("albedo"):
            if defer_uv:
                atl = atlas if atlas is not None \
                    else build_packed_atlas(part_textures,
                                            mip_levels=cfg.texture_mips)
                screen = None
                if atl is not None and atl.n_mips > 1 and cfg.texture_mips > 1:
                    screen, _, _ = raster.screen_from_clip(clip, width, height)
                fit = None
                if (screen is not None and cfg.texture_resident
                        and atl.mip_meta):
                    pn = atl.sizes.shape[0]
                    slot = (resident_slot_size(pn)
                            if int(cfg.texture_resident) == 1
                            else int(cfg.texture_resident))
                    slot = min(int(slot), atl.data.shape[0],
                               atl.data.shape[1])
                    # static degrade: if some part's chain never fits the
                    # slot, skip the resident path rather than erroring —
                    # it is an optimization, ON by default
                    fit = resident_fit_levels(atl, slot)
                if fit is not None:
                    # per-frame resident mip mini-atlas, with an EXACT
                    # fallback: when any part needs a finer level than its
                    # slot holds (magnification — the copy would cap
                    # detail, PARITY.md D7), the whole frame samples the
                    # big atlas instead. lax.cond runs ONE branch per
                    # frame; single-instance paths only (crowd ignores
                    # texture_resident, crowd_render_supported).
                    pid_np = _static_pid(tris.shape[0], static, pn)
                    g = uvs[tris]
                    sz0 = atl.sizes[jnp.asarray(pid_np)][:, ::-1]
                    lvl = _tri_mip_levels(g, sz0, screen, tris, atl.n_mips)
                    nl = jax.ops.segment_min(lvl, jnp.asarray(pid_np),
                                             num_segments=pn,
                                             indices_are_sorted=True)
                    any_capped = jnp.any(nl < jnp.asarray(fit))

                    def _resident(_):
                        mini, roff, rsz = build_resident_atlas(atl, nl,
                                                               slot)
                        rows = affine_uv_part_rows(
                            uvs, tris, atl, static, screen_xy=screen,
                            resident=(roff, rsz))
                        return character_albedo_windowed(
                            static, vis.tri, None, part_textures, mini,
                            bary=vis.bary, uv_rows=rows)

                    def _exact(_):
                        rows = affine_uv_part_rows(uvs, tris, atl, static,
                                                   screen_xy=screen)
                        return character_albedo_windowed(
                            static, vis.tri, None, part_textures, atl,
                            bary=vis.bary, uv_rows=rows)

                    albedo = jax.lax.cond(any_capped, _exact, _resident,
                                          None)
                else:
                    rows = (affine_uv_part_rows(uvs, tris, atl, static,
                                                screen_xy=screen)
                            if atl is not None
                            else affine_uv_rows(uvs, tris))
                    albedo = character_albedo_windowed(
                        static, vis.tri, None, part_textures, atl,
                        bary=vis.bary, uv_rows=rows)
            elif cfg.albedo_window:
                albedo = character_albedo_windowed(static, vis.tri, uv_px,
                                                   part_textures, atlas)
            else:
                albedo = character_albedo(static, vis.tri, uv_px,
                                          part_textures, atlas)

    pid = None

    def part_id():
        import numpy as _np
        bounds = jnp.asarray(_np.asarray(static.part_base, _np.int32))
        return jnp.clip(jnp.searchsorted(bounds, jnp.maximum(vis.tri, 0),
                                         side="right") - 1,
                        0, len(static.part_base) - 1)

    if part_color is not None:
        # material-morph albedo modulation (beyond-parity)
        mm_mul, mm_add = part_color
        pid = part_id()
        albedo = jnp.clip(albedo * mm_mul[pid] + mm_add[pid], 0.0, None)

    sphere_addend = None
    if mmd_maps is not None:
        # MMD extended shading (beyond-parity; the reference's shader
        # ignores toon + sphere maps): toon ramp multiplies albedo by the
        # per-part ramp at v = 0.5 - 0.5*dot(N, L); SPH sphere maps
        # multiply albedo, SPA maps add after shading — all sampled at
        # view-space-normal UVs
        import numpy as _np
        sphere_texs, sphere_modes, toon_ramps = mmd_maps
        if pid is None:
            pid = part_id()
        ldir = jnp.asarray(cfg.light_direction, jnp.float32)
        ldir = ldir / jnp.linalg.norm(ldir)
        ndl = -jnp.sum(nrm_px * ldir, -1)            # dot(N, toward-light)
        k = toon_ramps.shape[1]
        qi = jnp.clip(jnp.round((0.5 - 0.5 * ndl) * (k - 1)),
                      0, k - 1).astype(jnp.int32)
        ramp_flat = jnp.asarray(toon_ramps.reshape(-1, 3))
        albedo = albedo * ramp_flat[pid * k + qi]
        if any(m != 0 for m in _np.asarray(sphere_modes)):
            view_rot = mats["view"][:3, :3]
            nv = nrm_px @ view_rot.T
            uv_s = jnp.stack([nv[..., 0] * 0.5 + 0.5,
                              0.5 - nv[..., 1] * 0.5], -1)
            scol = character_albedo(static, vis.tri, uv_s, sphere_texs)
            modes_px = jnp.asarray(_np.asarray(sphere_modes))[pid]
            albedo = jnp.where((modes_px == 1)[..., None], albedo * scol,
                               albedo)
            sphere_addend = jnp.where((modes_px == 2)[..., None], scol, 0.0)

    with pass_scope("shade"):
        char_color = shade.shade_character(
            albedo, nrm_px, world_px,
            jnp.asarray(cfg.camera_pos, jnp.float32), cfg)
    if sphere_addend is not None:
        char_color = char_color + sphere_addend
    if edge_mask is not None:
        # outlines sit between background/ground and the character
        color = jnp.where((edge_mask & ~char_mask)[..., None],
                          edge_color_px, color)
    if sdepth is not None:
        # MSAA resolve: shade once per pixel (center attributes), coverage
        # from the 4 per-sample depths vs the (per-pixel) ground depth —
        # geometry edges against ground/skybox resolve at 1/4 steps
        mask_s = (sdepth < 1.0 - 1e-7) & (sdepth <= ground_depth[None])
        frac = jnp.mean(mask_s.astype(jnp.float32), axis=0)[..., None]
        color = color * (1.0 - frac) + char_color * frac
    else:
        color = jnp.where(char_mask[..., None], char_color, color)
    return jnp.clip(color, 0.0, 1.0)
