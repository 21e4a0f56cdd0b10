"""Tiled/binned triangle rasterizer — the hot-path raster on the GPU.

Same visibility-buffer semantics as `render.raster.rasterize` (LESS_EQUAL
z-test, y-down screen, guard-band near clip), organized for a GPU:

1. Binning (plain jnp): each triangle's screen bbox is expanded into (tile,
   entry) pairs (capped at e_max tiles/tri) and sorted by tile, triangle id
   breaking ties (draw order); the setup rows are gathered into sorted order
   so every tile's entries are contiguous.
2. One Pallas kernel through Triton (`_tile_kernel`): one program per
   (instance, tile). A program reads its own [start, start + count) entry
   window and folds it in a dynamic-trip loop into depth / triangle id /
   barycentric / attribute accumulators held in registers. Every
   interpolated quantity (barycentrics, z, attribute numerators, 1/w
   denominator) is affine in pixel coords, so setup bakes PLANE
   COEFFICIENTS into the rows and the kernel evaluates each channel with 2
   FMA (w0 comes free as 1 - w1 - w2). Programs share nothing; each writes
   only its own tile.
3. The one kernel body has static variants: depth-only (shadow maps),
   visibility plus `n_attrs` perspective-correct attribute channels
   interpolated in-kernel (shading needs no per-pixel vertex gathers), and
   native 4x MSAA (per-sample depth). The instance axis is folded into the
   grid, so a single frame is a crowd of one.
4. Triangles bigger than e_max tiles (close-ups, the rare giant polygon)
   fall back to the exact scan rasterizer and merge by depth.

The kernel compiles for the GPU and runs in Pallas interpret mode on the CPU
(the tests); any other backend is an error.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..render import raster

# tile shape: the per-pixel accumulators (depth, id, 2 barycentrics, 1/w
# denominator, one numerator per attribute, 4 sample depths at msaa=4) live
# in registers, so the tile is sized for the register file, not for memory
TILE_H = 16
TILE_W = 32
NUM_WARPS = 4

# row layout: ax, ay, w1x, w1y, w2x, w2y, z0, zx, zy, tri_id, then (with
# attributes) the 1/w denominator plane and one numerator plane per attribute
BASE_WIDTH = 10


def _interpret() -> bool:
    """Interpret mode on the CPU (tests), compiled on the GPU; no kernel
    exists for any other backend."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise NotImplementedError(
        f"the tiled raster kernel has no {backend!r} form; use "
        f"RenderConfig(raster_mode='scan')")


def _setup_rows(s, tri_ids, attrs=None):
    """Pack per-triangle setup into [T, W] f32 rows of screen-space PLANE
    coefficients, ANCHORED at vertex 0: every interpolated quantity is
    affine in pixel coords, so the kernel evaluates each channel as
    v0 + vx*(px-ax) + vy*(py-ay) (2 FMA after a shared dx/dy) instead of
    edge functions from vertex coordinates. Anchoring makes the constant
    term exact (w1(a) = w2(a) = 0, z(a) = z0), so precision matches the
    edge-function form; w0 comes free as 1 - w1 - w2.

    Layout: see BASE_WIDTH. With attrs [V,A] (their per-corner values
    [T,3,A] in s["va"]): den plane (3) + per-attr
    numerator planes (3A) appended (den = sum w_i/w_clip_i, num_a = sum
    w_i a_i/w_i — perspective-correct interpolation as in
    raster.interpolate). W is padded to a power of two."""
    xy = s["xy"]
    z = s["z"]
    inv_area = jnp.where(jnp.abs(s["area2"]) > 1e-12, 1.0 / s["area2"], 0.0)
    ax, ay = xy[:, 0, 0], xy[:, 0, 1]
    bx, by = xy[:, 1, 0], xy[:, 1, 1]
    cx, cy = xy[:, 2, 0], xy[:, 2, 1]

    # slopes of the barycentric planes (constants vanish at the anchor):
    # w1 = e20/area has gradient ((cy-ay), (ax-cx))/area
    w1x = (cy - ay) * inv_area
    w1y = (ax - cx) * inv_area
    # w2 = e01/area has gradient ((ay-by), (bx-ax))/area
    w2x = (ay - by) * inv_area
    w2y = (bx - ax) * inv_area

    def combo(v0, v1, v2):
        """Anchored plane of w0*v0 + w1*v1 + w2*v2 (w0 = 1 - w1 - w2):
        value(a) = v0 exactly, slopes from the barycentric gradients."""
        d1 = v1 - v0
        d2 = v2 - v0
        return (v0,
                d1 * w1x + d2 * w2x,
                d1 * w1y + d2 * w2y)

    z0, zx, zy = combo(z[:, 0], z[:, 1], z[:, 2])
    cols = [ax, ay, w1x, w1y, w2x, w2y, z0, zx, zy,
            tri_ids.astype(jnp.float32)]
    if attrs is not None:
        va = s["va"]                             # [T,3,A]
        iw = s["inv_w"]                          # [T,3]
        cols.extend(combo(iw[:, 0], iw[:, 1], iw[:, 2]))
        for a in range(attrs.shape[1]):
            cols.extend(combo(va[:, 0, a] * iw[:, 0],
                              va[:, 1, a] * iw[:, 1],
                              va[:, 2, a] * iw[:, 2]))
    width = 1 << (len(cols) - 1).bit_length()
    cols.extend([jnp.zeros_like(z0)] * (width - len(cols)))
    return jnp.stack(cols, axis=-1)


def _grid(width, height):
    """-> (tiles_x, n_tiles) of the tile grid covering a width x height
    target."""
    tiles_x = -(-width // TILE_W)
    return tiles_x, tiles_x * -(-height // TILE_H)


def _expand_tiles(s, width, height, e_max):
    """Per-triangle covered-tile enumeration -> (tile [T, E] with n_tiles
    for invalid/pad slots, big [T] oversized-triangle mask)."""
    tiles_x, n_tiles = _grid(width, height)

    xy = s["xy"]
    valid = s["valid"]
    xmin = jnp.clip(jnp.min(xy[:, :, 0], 1), 0.0, width - 1.0)
    xmax = jnp.clip(jnp.max(xy[:, :, 0], 1), 0.0, width - 1.0)
    ymin = jnp.clip(jnp.min(xy[:, :, 1], 1), 0.0, height - 1.0)
    ymax = jnp.clip(jnp.max(xy[:, :, 1], 1), 0.0, height - 1.0)
    on = ((jnp.max(xy[:, :, 0], 1) >= 0) & (jnp.min(xy[:, :, 0], 1) < width) &
          (jnp.max(xy[:, :, 1], 1) >= 0) & (jnp.min(xy[:, :, 1], 1) < height))
    valid = valid & on

    tx0 = (xmin // TILE_W).astype(jnp.int32)
    tx1 = (xmax // TILE_W).astype(jnp.int32)
    ty0 = (ymin // TILE_H).astype(jnp.int32)
    ty1 = (ymax // TILE_H).astype(jnp.int32)
    bw = tx1 - tx0 + 1
    bh = ty1 - ty0 + 1
    n_cover = bw * bh
    big = valid & (n_cover > e_max)
    small = valid & ~big

    # enumerate the bbox cells row-major: bw is tiny (1..e_max), so select
    # from precomputed (dx, dy) tables per bw instead of an integer div/mod
    # per entry
    e = jnp.arange(e_max, dtype=jnp.int32)[None, :]          # [1,E]
    bwc = jnp.clip(bw, 1, e_max)[:, None]
    dx = e
    dy = jnp.zeros_like(e)
    for width_c in range(1, e_max + 1):
        dxc = jnp.asarray([k % width_c for k in range(e_max)], jnp.int32)
        dyc = jnp.asarray([k // width_c for k in range(e_max)], jnp.int32)
        sel = bwc == width_c
        dx = jnp.where(sel, dxc[None, :], dx)
        dy = jnp.where(sel, dyc[None, :], dy)
    tile = (ty0[:, None] + dy) * tiles_x + (tx0[:, None] + dx)  # [T,E]
    mask = small[:, None] & (e < n_cover[:, None])
    return jnp.where(mask, tile, n_tiles), big                 # invalid -> pad


def _packed_sort(flat_tile, flat_tri, t, n_segments):
    """Sort (tile, tri) pairs lexicographically -> (sorted_tri [N], segment
    starts [n_segments + 1]); starts[n_segments] is the pad-segment
    boundary.

    Fast path: ONE packed int32 key (tile << tri_bits | tri) through an
    unstable single-operand sort — keys are unique, so this is equivalent
    to a stable pair sort and cheaper than the pair sort plus two
    permutation gathers. tri_bits is sized to the actual triangle count
    (trace-time constant), so the int32 budget covers (segments+1) * t up
    to 2^31 — e.g. 1M triangles at a 2040-tile 1080p grid. Beyond that the
    lexicographic two-operand sort takes over (exact, ~3x the sort cost;
    int64 keys are unavailable without jax_enable_x64)."""
    tri_bits = max(int(t - 1).bit_length(), 1)
    bound = jnp.arange(n_segments + 1, dtype=jnp.int32)
    if (n_segments + 1) <= (1 << (31 - tri_bits)):
        packed = jax.lax.sort(flat_tile * (1 << tri_bits) + flat_tri,
                              is_stable=False)
        sorted_tri = packed & ((1 << tri_bits) - 1)
        start = jnp.searchsorted(packed, bound * (1 << tri_bits),
                                 side="left").astype(jnp.int32)
    else:
        sorted_tile, sorted_tri = jax.lax.sort(
            (flat_tile, flat_tri), num_keys=2, is_stable=False)
        start = jnp.searchsorted(sorted_tile, bound,
                                 side="left").astype(jnp.int32)
    return sorted_tri, start


def _pin_pads(sorted_tri, n_real, t):
    """Pad entries (past the last real segment) carry scattered triangle
    ids — gather addresses for rows nobody reads. Pinning them into the
    first 256 rows keeps the row gather's footprint proportional to REAL
    entries without funneling millions of duplicate addresses onto one
    row."""
    eidx = jnp.arange(sorted_tri.shape[0], dtype=jnp.int32)
    spread = 256 if t >= 256 else 1      # power of two: & instead of %
    return jnp.where(eidx < n_real, sorted_tri, eidx & (spread - 1))


def _bin(s, rows, width, height, e_max):
    """-> (sorted_rows [T*E, W], starts [n_tiles], counts [n_tiles],
    big_mask [T]). Entries are sorted by tile and the ROWS are gathered
    into that order, so each tile's entries are contiguous: the kernel
    reads its [start, start + count) window directly — no dense-bin
    scatter."""
    _, n_tiles = _grid(width, height)
    tile, big = _expand_tiles(s, width, height, e_max)
    t = tile.shape[0]
    flat_tri = jnp.broadcast_to(
        jnp.arange(t, dtype=jnp.int32)[:, None], (t, e_max)).reshape(-1)
    sorted_tri, start = _packed_sort(tile.reshape(-1), flat_tri, t, n_tiles)
    # counts are UNCAPPED: the kernel loops over every entry of its tile,
    # so a dense tile never drops geometry
    counts = start[1:] - start[:-1]
    sorted_tri = _pin_pads(sorted_tri, start[n_tiles], t)
    return rows[sorted_tri], start[:n_tiles], counts, big


# validity-compacted PREFIX binning for the single-instance paths. Most
# scenes cull ~half their triangles (backface in the main view, frontface in
# the shadow pass — main.cpp:942) yet every triangle would occupy e_max sort
# slots and one gathered row; the bin's sort and row gather scale with the
# slot count, not the real-entry count. Compacting valid triangle ids to the
# front (ONE cheap T-key sort) and binning only a static prefix C >= n_valid
# cuts both by 1 - C/T. The prefix size is picked at runtime from a static
# ladder of fractions of T via lax.switch, so exactly ONE branch runs per
# frame. The crowd vmap FALLBACK disables compaction (render.pipeline reads
# RenderConfig.compact_bin), because switch under vmap batches to an
# all-branches select. Each rung traces the kernel once more.
COMPACT_MIN_T = 4096
COMPACT_RUNGS = ((3, 8), (5, 8))


def _bin_prefix(s, rows, width, height, e_max, run):
    """Compacted-prefix variant of _bin, driving `run` directly.

    run(sorted_rows, starts, counts) -> pytree (the kernel launch); it is
    traced once per ladder rung, and lax.switch executes the smallest rung
    with prefix >= the frame's valid-triangle count. Exact for every input:
    the prefix always contains every valid triangle, ids keep draw order
    through the packed sort's low bits, and invalid ids inside the prefix
    expand to pad entries exactly as in _bin. Returns (run outputs, big)."""
    _, n_tiles = _grid(width, height)
    tile, big = _expand_tiles(s, width, height, e_max)
    t = tile.shape[0]
    # slot 0 is real iff the triangle produced any entry at all
    valid_tri = tile[:, 0] < n_tiles
    n_valid = jnp.sum(valid_tri.astype(jnp.int32))

    vbits = max(int(t - 1).bit_length(), 1)
    assert t < (1 << 30), "prefix compaction id space exceeds the int32 key"
    key = (jnp.where(valid_tri, 0, 1 << vbits)
           + jnp.arange(t, dtype=jnp.int32))
    cids = jax.lax.sort(key, is_stable=False) & ((1 << vbits) - 1)

    def make_branch(c_n):
        def branch(_):
            ids = jax.lax.slice(cids, (0,), (c_n,))
            flat_tri = jnp.broadcast_to(ids[:, None],
                                        (c_n, e_max)).reshape(-1)
            sorted_tri, start = _packed_sort(tile[ids].reshape(-1), flat_tri,
                                             t, n_tiles)
            counts = start[1:] - start[:-1]
            sorted_tri = _pin_pads(sorted_tri, start[n_tiles], t)
            return run(rows[sorted_tri], start[:n_tiles], counts)
        return branch

    sizes = sorted({min(t, -(-(t * num) // den)) for num, den in COMPACT_RUNGS}
                   | {t})
    sizes = [c for c in sizes if c > 0]
    if len(sizes) == 1:
        return make_branch(sizes[0])(None), big
    idx = jnp.searchsorted(jnp.asarray(sizes, jnp.int32), n_valid,
                           side="left")
    return (jax.lax.switch(idx, [make_branch(c) for c in sizes], None), big)


# D3D11/OpenGL standard 4x MSAA sample pattern (pixel units from center)
MSAA4_OFFSETS = ((-0.125, -0.375), (0.375, -0.125),
                 (-0.375, 0.125), (0.125, 0.375))


def _tile_kernel(starts_ref, counts_ref, rows_ref, *out_refs, tiles_x,
                 n_tiles, n_attrs, samples, depth_only):
    """One program = one (instance, tile): fold the tile's entry window into
    per-pixel accumulators and write the tile.

    depth_only: min-fold of depth alone (shadow maps) — no winner tracking,
    no zp <= 1 test (implied by zp < depth, depth0 = 1).
    Otherwise: z-test with the scan raster's later-draw-wins tie rule as a
    max-id rule (entry ORDER never matters), carrying triangle id,
    barycentrics and, with n_attrs, the 1/w denominator and attribute
    numerators. samples == 4 adds per-sample depth at MSAA4_OFFSETS and
    extends center coverage to any-sample (edge pixels keep the front
    surface's attributes, like non-centroid GPU interpolation); entries
    not covering the exact center carry a +2 depth bias so a true center
    hit always beats an edge extrapolation (the caller removes the bias).
    """
    i = pl.program_id(0)
    local = i % n_tiles
    ty = local // tiles_x
    tx = local % tiles_x
    xs = (jax.lax.broadcasted_iota(jnp.int32, (1, TILE_W), 1)
          + tx * TILE_W).astype(jnp.float32) + 0.5            # [1,TW]
    ys = (jax.lax.broadcasted_iota(jnp.int32, (TILE_H, 1), 0)
          + ty * TILE_H).astype(jnp.float32) + 0.5            # [TH,1]
    start = starts_ref[i]
    count = counts_ref[i]
    shape = (TILE_H, TILE_W)

    def planes(r):
        def c(k):
            return rows_ref[r, k]
        dx = xs - c(0)
        dy = ys - c(1)
        w1 = c(2) * dx + c(3) * dy
        w2 = c(4) * dx + c(5) * dy
        zp = c(6) + c(7) * dx + c(8) * dy
        return c, dx, dy, w1, w2, zp

    if depth_only:
        def entry(e, depth):
            _, _, _, w1, w2, zp = planes(start + e)
            ok = (w1 >= 0) & (w2 >= 0) & (w1 + w2 <= 1.0) & (zp >= 0.0)
            return jnp.minimum(depth, jnp.where(ok, zp, 2.0))

        depth = jax.lax.fori_loop(0, count, entry,
                                  jnp.ones(shape, jnp.float32))
        out_refs[0][...] = depth
        return

    def entry(e, carry):
        depth, tri, b1, b2, den, num, sdepth = carry
        c, dx, dy, w1, w2, zp = planes(start + e)
        cover = (w1 >= 0) & (w2 >= 0) & (w1 + w2 <= 1.0)
        if samples == 1:
            zg = jnp.where(cover & (zp >= 0.0) & (zp <= 1.0), zp, 2.0)
        else:
            cover_any = None
            new_sd = []
            for s, (ox, oy) in enumerate(MSAA4_OFFSETS):
                w1s = w1 + (c(2) * ox + c(3) * oy)
                w2s = w2 + (c(4) * ox + c(5) * oy)
                zs = zp + (c(7) * ox + c(8) * oy)
                cover_s = (w1s >= 0) & (w2s >= 0) & (w1s + w2s <= 1.0)
                cover_any = cover_s if s == 0 else cover_any | cover_s
                new_sd.append(jnp.minimum(
                    sdepth[s], jnp.where(cover_s & (zs >= 0.0), zs, 2.0)))
            sdepth = tuple(new_sd)
            zg = jnp.where(cover_any & (zp >= 0.0) & (zp <= 1.0),
                           zp + jnp.where(cover, 0.0, 2.0), 4.0)
        tid = c(9).astype(jnp.int32)
        passed = (zg < depth) | ((zg == depth) & (tid > tri))
        depth = jnp.where(passed, zg, depth)
        tri = jnp.where(passed, tid, tri)
        b1 = jnp.where(passed, w1, b1)
        b2 = jnp.where(passed, w2, b2)
        if n_attrs:
            def plane(k):
                return c(k) + c(k + 1) * dx + c(k + 2) * dy
            den = jnp.where(passed, plane(BASE_WIDTH), den)
            num = tuple(jnp.where(passed, plane(BASE_WIDTH + 3 + 3 * a),
                                  num[a]) for a in range(n_attrs))
        return depth, tri, b1, b2, den, num, sdepth

    zeros = jnp.zeros(shape, jnp.float32)
    ones = jnp.ones(shape, jnp.float32)
    init = (jnp.full(shape, 1.0 if samples == 1 else 3.0, jnp.float32),
            jnp.full(shape, -1, jnp.int32), zeros, zeros,
            ones if n_attrs else None,
            tuple(zeros for _ in range(n_attrs)),
            tuple(ones for _ in range(samples if samples > 1 else 0)))
    depth, tri, b1, b2, den, num, sdepth = jax.lax.fori_loop(
        0, count, entry, init)
    depth_ref, tri_ref, b1_ref, b2_ref, *rest = out_refs
    depth_ref[...] = depth
    tri_ref[...] = tri
    b1_ref[...] = b1
    b2_ref[...] = b2
    if n_attrs:
        safe = jnp.where(jnp.abs(den) > 1e-9, den, 1.0)
        for a in range(n_attrs):
            rest[a][...] = num[a] / safe
    for s in range(len(sdepth)):
        rest[n_attrs + s][...] = sdepth[s]


def _run_tiles(sorted_rows, starts, counts, n_inst, width, height, *,
               n_attrs=0, samples=1, depth_only=False):
    """Launch `_tile_kernel` over n_inst x the tile grid.

    starts/counts: [n_inst * n_tiles] entry windows into sorted_rows.
    Returns cropped [n_inst, height, width] planes: (depth,) when
    depth_only, else (depth, tri, b1, b2, *attrs, *sample_depths)."""
    tiles_x, n_tiles = _grid(width, height)
    pad_h = -(-height // TILE_H) * TILE_H
    pad_w = tiles_x * TILE_W

    def index(i):
        local = i % n_tiles
        return i // n_tiles, local // tiles_x, local % tiles_x

    f32 = jax.ShapeDtypeStruct((n_inst, pad_h, pad_w), jnp.float32)
    if depth_only:
        out_shape = [f32]
    else:
        i32 = jax.ShapeDtypeStruct((n_inst, pad_h, pad_w), jnp.int32)
        out_shape = ([f32, i32, f32, f32] + [f32] * n_attrs
                     + [f32] * (samples if samples > 1 else 0))
    variant = ("depth" if depth_only else
               f"vis_a{n_attrs}" + ("_msaa4" if samples > 1 else ""))
    outs = pl.pallas_call(
        partial(_tile_kernel, tiles_x=tiles_x, n_tiles=n_tiles,
                n_attrs=n_attrs, samples=samples, depth_only=depth_only),
        grid=(n_inst * n_tiles,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 3,
        out_specs=[pl.BlockSpec((None, TILE_H, TILE_W), index)
                   for _ in out_shape],
        out_shape=out_shape,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=_interpret(),
        name=f"tile_raster_{variant}",
    )(starts, counts, sorted_rows)
    return tuple(o[:, :height, :width] for o in outs)


def _vis_outputs(outs, n_attrs):
    """(depth, tri, b1, b2, *attrs, *sample depths) planes -> (VisBuffer,
    attr [I,H,W,A] zeroed on empty pixels, sample depth [I,S,H,W] or
    None)."""
    depth, tri, b1, b2 = outs[:4]
    vis = raster.VisBuffer(depth=depth, tri=tri,
                           bary=jnp.stack([b1, b2], -1))
    attr = (jnp.stack(outs[4:4 + n_attrs], -1) if n_attrs
            else jnp.zeros(tri.shape + (1,), jnp.float32))
    attr = jnp.where((tri >= 0)[..., None], attr, 0.0)
    sd = outs[4 + n_attrs:]
    return vis, attr, (jnp.stack(sd, 1) if sd else None)


def _unbias(depth, tri):
    """Remove the MSAA center bias: empty stays far (1.0), edge winners
    drop the +2."""
    return jnp.where(tri < 0, 1.0, jnp.where(depth > 1.5, depth - 2.0, depth))


def _squeeze(vis):
    return jax.tree.map(lambda x: x[0], vis)


BIG_TRI_CAP = 64


def _covers_all(e_max, width, height) -> bool:
    """True when e_max >= the whole tile grid: no triangle can overflow into
    the big-tri fallback, so the merge is skipped AT TRACE TIME. This matters
    under vmap (crowds): lax.cond batches to a both-branches select, so the
    fallback's full-frame scan would otherwise run for every instance every
    frame even with zero big triangles."""
    return e_max >= _grid(width, height)[1]


def _big_subset(s, big, cap):
    """Stable-compact the oversized triangles to the front and keep `cap`
    of them -> (order [cap], masked setup of that subset)."""
    order = jnp.argsort(~big, stable=True)[:cap]
    s_big = {"xy": s["xy"][order], "z": s["z"][order],
             "area2": s["area2"][order],
             "valid": (s["valid"] & big)[order]}
    return order, s_big


def _merge_big(vis, attr, clip, tris, width, height, s, big, attrs):
    """Exact scan raster over oversized triangles, merged by depth.

    Only the first BIG_TRI_CAP oversized triangles are rasterized (compacted
    to the front with a stable sort), so a close-up can never degenerate into
    a full scan over the whole mesh — the fallback's cost is bounded at
    ~BIG_TRI_CAP full-frame edge evaluations, and only when triggered.
    Returns (vis, attr [H,W,A], big_won [H,W])."""
    def merge(args):
        vis, attr = args
        order, s_big = _big_subset(s, big, min(BIG_TRI_CAP, tris.shape[0]))
        vis_big = raster.scan(s_big, width, height)
        # map compacted ids back to original triangle ids
        real_tri = jnp.where(vis_big.tri >= 0,
                             order[jnp.maximum(vis_big.tri, 0)], -1)
        better = (vis_big.depth <= vis.depth) & (vis_big.tri >= 0)
        merged = raster.VisBuffer(
            depth=jnp.where(better, vis_big.depth, vis.depth),
            tri=jnp.where(better, real_tri, vis.tri),
            bary=jnp.where(better[..., None], vis_big.bary, vis.bary))
        if attrs is not None:
            big_attr = raster.interpolate(vis_big, clip, tris[order], attrs)
            attr = jnp.where(better[..., None], big_attr, attr)
        return merged, attr, better

    return jax.lax.cond(
        jnp.any(big), merge,
        lambda a: (a[0], a[1], jnp.zeros(a[0].depth.shape, bool)),
        (vis, attr))


def _merge_big_depth(depth, tris, width, height, s, big):
    """Depth-only form of _merge_big (shadow maps)."""
    def merge(depth):
        _, s_big = _big_subset(s, big, min(BIG_TRI_CAP, tris.shape[0]))
        return jnp.minimum(depth, raster.scan(s_big, width, height).depth)

    return jax.lax.cond(jnp.any(big), merge, lambda d: d, depth)


def _single(s, rows, width, height, e_max, compact, t, **kernel):
    """Bin one instance (prefix-compacted when `compact`) and run the
    kernel as a crowd of one -> (kernel planes [1,H,W] each, big)."""
    def run(sorted_rows, starts, counts):
        return _run_tiles(sorted_rows, starts, counts, 1, width, height,
                          **kernel)
    if compact and t >= COMPACT_MIN_T:
        return _bin_prefix(s, rows, width, height, e_max, run)
    sorted_rows, starts, counts, big = _bin(s, rows, width, height, e_max)
    return run(sorted_rows, starts, counts), big


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 8))
def rasterize_attrs_tiled_msaa(clip, tris, attrs, width, height,
                               cull=raster.CULL_BACK, e_max=9, nocull=None,
                               compact=True, cv=None, va=None):
    """4x-MSAA raster: center visibility + attributes like
    rasterize_attrs_tiled, PLUS per-sample depth [4, H, W] at the standard
    rotated-grid offsets. A sample is covered iff its depth < 1.0.

    Big-triangle fallback approximates all four samples with the center
    result (oversized triangles are interior-dominated). `cv`/`va`: see
    rasterize_attrs_tiled."""
    if cv is None:
        g = jnp.concatenate([clip, attrs], -1)[tris]
        cv, va = g[..., :4], g[..., 4:]
    s = raster.setup(clip, tris, width, height, cull, cv=cv,
                     sample_extent=0.375, nocull=nocull)
    s["va"] = va
    rows = _setup_rows(s, jnp.arange(tris.shape[0], dtype=jnp.int32), attrs)
    na = attrs.shape[1]
    outs, big = _single(s, rows, width, height, e_max, compact,
                        tris.shape[0], n_attrs=na, samples=4)
    vis, attr, sdepth = _squeeze(_vis_outputs(outs, na))
    vis = vis.replace(depth=_unbias(vis.depth, vis.tri))
    if not _covers_all(e_max, width, height):
        vis, attr, big_won = _merge_big(vis, attr, clip, tris, width, height,
                                        s, big, attrs)
        sdepth = jnp.where(big_won[None], jnp.minimum(sdepth, vis.depth[None]),
                           sdepth)
    return vis, attr, sdepth


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 7))
def rasterize_depth_tiled(clip, tris, width, height, cull=raster.CULL_BACK,
                          e_max=9, nocull=None, compact=True, cv=None):
    """Depth-only binned rasterization (shadow maps): returns [H, W] depth
    with the same z-test semantics as rasterize_tiled().depth. `cv` may
    pass pre-gathered per-corner clip coords [T,3,4] (see
    rasterize_attrs_tiled) — skips this pass's own 3T-row vertex gather."""
    s = raster.setup(clip, tris, width, height, cull, cv=cv, nocull=nocull)
    rows = _setup_rows(s, jnp.arange(tris.shape[0], dtype=jnp.int32))
    (depth,), big = _single(s, rows, width, height, e_max, compact,
                            tris.shape[0], depth_only=True)
    depth = depth[0]
    if _covers_all(e_max, width, height):
        return depth
    return _merge_big_depth(depth, tris, width, height, s, big)


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def rasterize_tiled(clip, tris, width, height, cull=raster.CULL_BACK,
                    e_max=9, compact=True) -> raster.VisBuffer:
    """Binned-tile rasterization; semantics match raster.rasterize. Tiles
    with any number of entries render exactly."""
    s = raster.setup(clip, tris, width, height, cull)
    rows = _setup_rows(s, jnp.arange(tris.shape[0], dtype=jnp.int32))
    outs, big = _single(s, rows, width, height, e_max, compact,
                        tris.shape[0])
    vis, attr, _ = _squeeze(_vis_outputs(outs, 0))
    if not _covers_all(e_max, width, height):
        vis, _, _ = _merge_big(vis, attr, clip, tris, width, height, s, big,
                               None)
    return vis


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 8))
def rasterize_attrs_tiled(clip, tris, attrs, width, height,
                          cull=raster.CULL_BACK, e_max=9, nocull=None,
                          compact=True, cv=None, va=None):
    """Raster + in-kernel perspective-correct attribute interpolation.

    attrs: [V, A] per-vertex attributes. Returns (VisBuffer,
    attr_img [H, W, A]) with zeros on empty pixels. `nocull` [T] exempts
    double-sided triangles from face culling. `compact` enables validity-
    compacted prefix binning (_bin_prefix) — keep it False under vmap.
    `cv`/`va` may pass pre-gathered per-corner clip coords [T,3,4] and
    attributes [T,3,A]: callers rendering several passes over the same
    triangles (shadow + main) gather the corner table ONCE and transform
    per pass."""
    if cv is None:
        # fuse the clip and attribute vertex gathers into one [T,3,4+A] one
        g = jnp.concatenate([clip, attrs], -1)[tris]
        cv, va = g[..., :4], g[..., 4:]
    s = raster.setup(clip, tris, width, height, cull, cv=cv,
                     nocull=nocull)
    s["va"] = va
    rows = _setup_rows(s, jnp.arange(tris.shape[0], dtype=jnp.int32), attrs)
    na = attrs.shape[1]
    outs, big = _single(s, rows, width, height, e_max, compact,
                        tris.shape[0], n_attrs=na)
    vis, attr, _ = _squeeze(_vis_outputs(outs, na))
    if not _covers_all(e_max, width, height):
        vis, attr, _ = _merge_big(vis, attr, clip, tris, width, height, s,
                                  big, attrs)
    return vis, attr


def binning_stats(clip, tris, width, height, cull=raster.CULL_BACK,
                  e_max=6):
    """Binning diagnostics for a scene at given raster parameters.

    Per-tile capacity is unbounded (the kernel loops over every entry), so
    the only drop cliff is BIG_TRI_CAP for triangles spanning more than
    e_max tiles; max_tile_entries is the dense-tile cost driver. Returns
    dict(max_tile_entries, total_entries, n_big, big_capacity,
    big_dropped)."""
    s = raster.setup(clip, tris, width, height, cull)
    rows = _setup_rows(s, jnp.arange(tris.shape[0], dtype=jnp.int32))
    _, _, counts, big = _bin(s, rows, width, height, e_max)
    n_big = int(jnp.sum(big))
    return dict(
        max_tile_entries=int(jnp.max(counts)),
        total_entries=int(jnp.sum(counts)),
        n_big=n_big,
        big_capacity=int(BIG_TRI_CAP),
        big_dropped=max(0, n_big - BIG_TRI_CAP),
    )


# ---------------------------------------------------------------------------
# Fused multi-instance (crowd) raster: ONE sort and ONE kernel launch over
# instance x tile — vmapping the single-instance path pays per-instance
# fixed costs (batched small sorts, small kernel grids) that dominate at
# crowd viewport sizes.
# ---------------------------------------------------------------------------

# max bbox tiles per triangle in the FUSED crowd binning. Covers-all
# (e_max = n_tiles) is exact with no fallback, but its entry count
# instances*T*n_tiles grows past device memory at dense crowds (64
# instances of the bench-density character against the 128-tile grid of a
# 256^2 shadow map is 210M entries). bbox expansion bounds entries at instances*T*E;
# oversized triangles go through the same capped scan fallback as the
# single-instance path.
CROWD_E_MAX = 6


def _crowd_e_max(width, height) -> int:
    return min(_grid(width, height)[1], CROWD_E_MAX)


# fused crowd binning runs in up to this many validity-compacted passes:
# pass k bins the compacted triangle ids [k*ceil(I*T/DIV), ...). At crowd
# viewports ~90% of triangles fail the sample-point/face cull (a 25.6k-tri
# character at 256x144 keeps 2.8k), yet every triangle would occupy E sort
# slots and one sorted row. Compaction sorts tris by (valid, draw order)
# once and bins only ceil(I*T/DIV) of them per pass; passes whose id range
# holds no valid triangle are lax.cond-skipped (their big buffers never
# materialize). Exact for EVERY input: all DIV passes together cover all
# triangles, and later passes hold higher draw ids, so the depth merge's
# later-wins tie rule reproduces the single-sort draw order.
CROWD_COMPACT_DIV = 4


def _crowd_compact_passes(s, rows, width, height, run_pass, empty_pass,
                          merge):
    """Validity-compacted fused crowd binning driver.

    s: vmapped setup dicts, rows: [I, T, W] setup rows.
    run_pass(sorted_rows, starts, counts) -> pytree of pass outputs;
    empty_pass() -> the same pytree for a pass that rendered nothing;
    merge(a, b) -> pytree combining pass a with LATER pass b (later wins
    depth ties). Returns (merged outputs, big [I, T])."""
    _, n_tiles = _grid(width, height)
    e_max = _crowd_e_max(width, height)
    n_inst, t = rows.shape[0], rows.shape[1]
    n = n_inst * t

    tile, big = jax.vmap(
        lambda si: _expand_tiles(si, width, height, e_max))(s)  # [I,T,E]
    inst = jnp.arange(n_inst, dtype=jnp.int32)[:, None, None]
    gtile = jnp.where(tile < n_tiles, inst * n_tiles + tile,
                      n_inst * n_tiles)
    gt_flat = gtile.reshape(n, e_max)
    # slot 0 is real iff the triangle produced any entry at all
    valid_tri = gt_flat[:, 0] < n_inst * n_tiles
    n_valid = jnp.sum(valid_tri.astype(jnp.int32))

    # compaction: valid tris first, draw order (global id) within each group
    vbits = max(int(n - 1).bit_length(), 1)
    assert n < (1 << 30), "crowd id space exceeds the int32 sort key"
    key1 = (jnp.where(valid_tri, 0, 1 << vbits)
            + jnp.arange(n, dtype=jnp.int32))
    cids = jax.lax.sort(key1, is_stable=False) & ((1 << vbits) - 1)

    c_v = -(-n // CROWD_COMPACT_DIV)
    n_pass = -(-n // c_v)
    cids = jnp.pad(cids, (0, n_pass * c_v - n), constant_values=n)

    # +1 all-zero pad row addressed by id n
    flat_rows = jnp.pad(rows.reshape(n, rows.shape[2]), ((0, 1), (0, 0)))
    gt_pad = jnp.pad(gt_flat, ((0, 1), (0, 0)),
                     constant_values=n_inst * n_tiles)

    def make_pass(k):
        def run(_):
            ids = jax.lax.dynamic_slice(cids, (k * c_v,), (c_v,))
            flat_gid = jnp.broadcast_to(ids[:, None],
                                        (c_v, e_max)).reshape(-1)
            # t = n + 1: the cids tail padding uses id n (the all-pad row),
            # so the packed key's value bits must cover it
            sorted_gid, start = _packed_sort(gt_pad[ids].reshape(-1),
                                             flat_gid, n + 1,
                                             n_inst * n_tiles)
            counts = start[1:] - start[:-1]
            sorted_gid = _pin_pads(sorted_gid, start[n_inst * n_tiles], n)
            return run_pass(flat_rows[sorted_gid],
                            start[:n_inst * n_tiles], counts)
        return run

    out = make_pass(0)(None)
    for k in range(1, n_pass):
        out = merge(out, jax.lax.cond(n_valid > k * c_v, make_pass(k),
                                      lambda _: empty_pass(), None))
    return out, big


def _crowd_setup(clip, tris, attrs, width, height, cull, cv, va, nocull,
                 sample_extent=0.0):
    """Per-instance setup dicts and rows for the fused crowd raster."""
    if cv is None:
        def per_inst(clip_i, attrs_i):
            g = jnp.concatenate([clip_i, attrs_i], -1)[tris]
            s = raster.setup(clip_i, tris, width, height, cull,
                             cv=g[..., :4], sample_extent=sample_extent,
                             nocull=nocull)
            s["va"] = g[..., 4:]
            return s

        s = jax.vmap(per_inst)(clip, attrs)
    else:
        def per_inst_cv(clip_i, cv_i, va_i):
            s = raster.setup(clip_i, tris, width, height, cull, cv=cv_i,
                             sample_extent=sample_extent, nocull=nocull)
            s["va"] = va_i
            return s

        s = jax.vmap(per_inst_cv)(clip, cv, va)
    rows = jax.vmap(
        lambda si, ai: _setup_rows(
            si, jnp.arange(tris.shape[0], dtype=jnp.int32), ai))(s, attrs)
    return s, rows


def _crowd_vis(clip, tris, attrs, width, height, cull, cv, va, nocull,
               samples):
    """Shared body of the fused crowd visibility rasters."""
    s, rows = _crowd_setup(clip, tris, attrs, width, height, cull, cv, va,
                           nocull, sample_extent=0.375 if samples > 1
                           else 0.0)
    n_inst = clip.shape[0]
    na = attrs.shape[-1]
    n_sd = samples if samples > 1 else 0

    def run_pass(sorted_rows, starts, counts):
        return _run_tiles(sorted_rows, starts, counts, n_inst, width, height,
                          n_attrs=na, samples=samples)

    def empty_pass():
        plane = jnp.zeros((n_inst, height, width), jnp.float32)
        # biased clear (3.0) for the MSAA center depth, see _tile_kernel
        return ((plane + (1.0 if samples == 1 else 3.0),
                 jnp.full((n_inst, height, width), -1, jnp.int32),
                 plane, plane) + (plane,) * na + (plane + 1.0,) * n_sd)

    def merge(a, b):
        d1, t1 = a[0], a[1]
        d2, t2 = b[0], b[1]
        better = (t2 >= 0) & ((d2 < d1) | ((d2 == d1) & (t2 > t1)))
        head = tuple(jnp.where(better, x2, x1)
                     for x1, x2 in zip(a[:4 + na], b[:4 + na]))
        # sample depths fold by min, independent of the center winner
        return head + tuple(jnp.minimum(x1, x2)
                            for x1, x2 in zip(a[4 + na:], b[4 + na:]))

    outs, big = _crowd_compact_passes(s, rows, width, height, run_pass,
                                      empty_pass, merge)
    vis, attr, sdepth = _vis_outputs(outs, na)
    if samples > 1:
        vis = vis.replace(depth=_unbias(vis.depth, vis.tri))
    if not _covers_all(_crowd_e_max(width, height), width, height):
        def merge_big(args):
            def one(vis_i, attr_i, clip_i, s_i, big_i, attrs_i):
                return _merge_big(vis_i, attr_i, clip_i, tris, width, height,
                                  s_i, big_i, attrs_i)
            # the any-big cond sits OUTSIDE the vmap (under vmap lax.cond
            # batches to a both-branches select, which would pay the
            # full-frame scan every frame)
            return jax.vmap(one)(*args)

        vis, attr, big_won = jax.lax.cond(
            jnp.any(big), merge_big,
            lambda a: (a[0], a[1], jnp.zeros(a[0].depth.shape, bool)),
            (vis, attr, clip, s, big, attrs))
        if sdepth is not None:
            sdepth = jnp.where(big_won[:, None],
                               jnp.minimum(sdepth, vis.depth[:, None]),
                               sdepth)
    return vis, attr, sdepth


@partial(jax.jit, static_argnums=(3, 4, 5))
def rasterize_attrs_tiled_crowd(clip, tris, attrs, width, height,
                                cull=raster.CULL_BACK, cv=None, va=None,
                                nocull=None):
    """Fused multi-instance raster + attribute interpolation.

    clip [I,V,4], tris [T,3] (shared topology), attrs [I,V,A] ->
    (VisBuffer with leading instance axis, attr [I,H,W,A]). Binning is
    bbox-limited (_crowd_e_max); oversized triangles merge through the same
    capped scan fallback as the single-instance path. Per-pixel/per-entry
    semantics identical to rasterize_attrs_tiled. `cv` [I,T,3,4] /
    `va` [I,T,3,A] pass pre-gathered corner tables shared with the crowd
    shadow pass (see crowd_render_frame). `nocull` [T] (shared across
    instances, like the topology) exempts those triangles from face
    culling — double-sided materials."""
    vis, attr, _ = _crowd_vis(clip, tris, attrs, width, height, cull, cv, va,
                              nocull, 1)
    return vis, attr


@partial(jax.jit, static_argnums=(3, 4, 5))
def rasterize_attrs_tiled_msaa_crowd(clip, tris, attrs, width, height,
                                     cull=raster.CULL_BACK, cv=None,
                                     va=None, nocull=None):
    """Fused multi-instance 4x-MSAA raster: per-pixel center visibility +
    attributes plus per-sample depth [I, 4, H, W], semantics identical to
    rasterize_attrs_tiled_msaa per instance (bbox binning; big triangles
    merge with the center-approximated samples, like the single path).
    `cv`/`va`/`nocull`: see rasterize_attrs_tiled_crowd."""
    return _crowd_vis(clip, tris, attrs, width, height, cull, cv, va, nocull,
                      4)


@partial(jax.jit, static_argnums=(2, 3, 4))
def rasterize_depth_tiled_crowd(clip, tris, width, height,
                                cull=raster.CULL_FRONT, cv=None):
    """Fused multi-instance depth-only raster (crowd shadow maps).

    clip [I,V,4], tris [T,3] -> depth [I,H,W]. `cv` [I,T,3,4] passes
    pre-gathered corner clip coords (see rasterize_attrs_tiled_crowd)."""
    if cv is None:
        s = jax.vmap(
            lambda c: raster.setup(c, tris, width, height, cull))(clip)
    else:
        s = jax.vmap(
            lambda c, cv_i: raster.setup(c, tris, width, height, cull,
                                         cv=cv_i))(clip, cv)
    rows = jax.vmap(
        lambda si: _setup_rows(
            si, jnp.arange(tris.shape[0], dtype=jnp.int32)))(s)
    n_inst = clip.shape[0]
    (depth,), big = _crowd_compact_passes(
        s, rows, width, height,
        lambda sr, st, ct: _run_tiles(sr, st, ct, n_inst, width, height,
                                      depth_only=True),
        lambda: (jnp.ones((n_inst, height, width), jnp.float32),),
        lambda a, b: (jnp.minimum(a[0], b[0]),))
    if _covers_all(_crowd_e_max(width, height), width, height):
        return depth

    def merge_big(args):
        return jax.vmap(lambda d, s_i, b_i: _merge_big_depth(
            d, tris, width, height, s_i, b_i))(*args)
    return jax.lax.cond(jnp.any(big), merge_big, lambda a: a[0],
                        (depth, s, big))
