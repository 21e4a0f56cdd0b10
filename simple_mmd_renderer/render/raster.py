"""Software triangle rasterizer -> visibility buffer.

Replaces the reference's GPU pipeline state (sokol `sg_draw` + depth test,
`main.cpp:2013-2189`) with pure array passes that write HBM framebuffers:

    clip-space transform -> screen mapping (y down) -> edge functions ->
    z-test -> visibility buffer {tri_id, barycentrics, depth}

Shading is deferred (render/shade.py): coverage is a dense data-parallel
computation, shading is pure elementwise work on [H,W] arrays.

Two paths share the same semantics:
- `rasterize` (this module): lax.scan over triangles, exact, any scene size —
  the CPU-testable reference (the "dummy backend" of SURVEY.md §4).
- `ops.tiled_raster`: binned tile rasterizer for the hot path.

Depth convention: zero-to-one (RH_ZO like the reference, `main.cpp:1897`),
z-less wins, cleared to 1.0.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils import pytree

CULL_NONE, CULL_BACK, CULL_FRONT = 0, 1, 2
_W_EPS = 1e-6


@pytree.dataclass
class VisBuffer:
    depth: jnp.ndarray   # [H,W] f32, 1.0 = far/empty
    tri: jnp.ndarray     # [H,W] i32, -1 = empty
    bary: jnp.ndarray    # [H,W,2] f32 screen-space (u,v) for verts 1,2


def transform_clip(positions, mvp):
    """[V,3] model/world-space points -> [V,4] clip coords (p' = MVP @ p)."""
    p = jnp.concatenate(
        [positions, jnp.ones(positions.shape[:-1] + (1,), positions.dtype)], -1)
    return p @ mvp.T


def screen_from_clip(clip, width, height):
    """NDC -> pixel coordinates, y flipped (row 0 = top), plus z and 1/w."""
    w = clip[..., 3]
    inv_w = jnp.where(jnp.abs(w) > _W_EPS, 1.0 / w, 0.0)
    ndc = clip[..., :3] * inv_w[..., None]
    x = (ndc[..., 0] * 0.5 + 0.5) * width
    y = (1.0 - (ndc[..., 1] * 0.5 + 0.5)) * height
    return jnp.stack([x, y], -1), ndc[..., 2], inv_w


def setup(clip, tris, width, height, cull=CULL_BACK, cv=None,
          sample_extent=0.0, nocull=None):
    """Per-triangle rasterization setup.

    Returns dict of [T,...] arrays: screen xy per vertex, z per vertex, 1/w per
    vertex, valid mask (in front of camera, non-degenerate, not culled).
    Triangles crossing w<=0 are dropped (guard-band near clip). `cv` may pass
    pre-gathered clip[tris] (callers fuse it with their attribute gather).
    `sample_extent` widens the sample-point cull for MSAA samples offset up
    to that many pixels from the center (0 = center sampling). `nocull` [T]
    marks triangles exempt from face culling (double-sided materials)."""
    # one gather of clip coords per triangle corner; the screen mapping is
    # recomputed on the gathered [T,3,4] (the gather costs more than the math)
    if cv is None:
        cv = clip[tris]                           # [T,3,4]
    xy, z, iw = screen_from_clip(cv, width, height)
    w_ok = jnp.all(cv[..., 3] > _W_EPS, axis=-1)

    d1 = xy[:, 1] - xy[:, 0]
    d2 = xy[:, 2] - xy[:, 0]
    area2 = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]  # y-down: CW>0

    if cull == CULL_BACK:
        face_ok = area2 < 0.0
    elif cull == CULL_FRONT:
        face_ok = area2 > 0.0
    else:
        face_ok = jnp.abs(area2) > 0.0
    if nocull is not None:
        face_ok = face_ok | (nocull & (jnp.abs(area2) > 0.0))

    # sample-point cull (exact): pixel centers sit at integer+0.5, so a
    # triangle whose bbox straddles no center in x or y can never produce
    # coverage. Dense meshes are full of such sub-sample triangles — this
    # keeps them out of the per-tile entry lists entirely.
    xmin = jnp.min(xy[..., 0], -1)
    xmax = jnp.max(xy[..., 0], -1)
    ymin = jnp.min(xy[..., 1], -1)
    ymax = jnp.max(xy[..., 1], -1)
    e = float(sample_extent)
    hits_sample = ((jnp.ceil(xmin - 0.5 - e) <= jnp.floor(xmax - 0.5 + e))
                   & (jnp.ceil(ymin - 0.5 - e) <= jnp.floor(ymax - 0.5 + e)))

    valid = w_ok & face_ok & (jnp.abs(area2) > 1e-12) & hits_sample
    return dict(xy=xy, z=z, inv_w=iw, area2=area2, valid=valid)


def _pixel_centers(width, height):
    ys = (jnp.arange(height, dtype=jnp.float32) + 0.5)[:, None]
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5)[None, :]
    return xs, ys


@partial(jax.jit, static_argnums=(2, 3, 4))
def rasterize(clip, tris, width, height, cull=CULL_BACK,
              vis: VisBuffer | None = None, nocull=None) -> VisBuffer:
    """Exact scanline-free rasterization: lax.scan over triangles, full-frame
    edge-function evaluation each (reference path; use ops.tiled_raster for
    speed on large scenes)."""
    return scan(setup(clip, tris, width, height, cull, nocull=nocull),
                width, height, vis)


def scan(s, width, height, vis: VisBuffer | None = None) -> VisBuffer:
    """The scan body of `rasterize` over a precomputed (possibly masked)
    setup `s`; triangle ids are positions in `s`."""
    if vis is None:
        vis = empty_vis(width, height)

    xs, ys = _pixel_centers(width, height)

    def body(carry, tri_in):
        depth, tri_id, bary = carry
        xy, z, area2, valid, tid = tri_in
        inv_area = jnp.where(jnp.abs(area2) > 1e-12, 1.0 / area2, 0.0)

        def edge(a, b):
            # (b - a) x (p - a): same sign as area2 for interior points
            return ((b[0] - a[0]) * (ys - a[1]) - (b[1] - a[1]) * (xs - a[0]))

        e12 = edge(xy[1], xy[2])  # weight of v0
        e20 = edge(xy[2], xy[0])  # weight of v1
        e01 = edge(xy[0], xy[1])  # weight of v2
        b0 = e12 * inv_area
        b1 = e20 * inv_area
        b2 = e01 * inv_area
        cover = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & valid
        zp = b0 * z[0] + b1 * z[1] + b2 * z[2]
        # LESS_EQUAL like every reference pipeline (main.cpp:1315, 940, 1352)
        passed = cover & (zp <= depth) & (zp >= 0.0) & (zp <= 1.0)
        depth = jnp.where(passed, zp, depth)
        tri_id = jnp.where(passed, tid, tri_id)
        bary = jnp.where(passed[..., None], jnp.stack([b1, b2], -1), bary)
        return (depth, tri_id, bary), None

    t = s["xy"].shape[0]
    tids = jnp.arange(t, dtype=jnp.int32)
    (depth, tri_id, bary), _ = jax.lax.scan(
        body, (vis.depth, vis.tri, vis.bary),
        (s["xy"], s["z"], s["area2"], s["valid"], tids))
    return VisBuffer(depth=depth, tri=tri_id, bary=bary)


def empty_vis(width, height) -> VisBuffer:
    return VisBuffer(
        depth=jnp.ones((height, width), jnp.float32),
        tri=jnp.full((height, width), -1, jnp.int32),
        bary=jnp.zeros((height, width, 2), jnp.float32))


def interpolate(vis: VisBuffer, clip, tris, attrs):
    """Perspective-correct interpolation of per-vertex attributes over the
    visibility buffer. attrs: [V,A] -> [H,W,A]; empty pixels get zeros."""
    tid = jnp.maximum(vis.tri, 0)
    v = tris[tid]                      # [H,W,3]
    iw = jnp.where(jnp.abs(clip[v][..., 3]) > _W_EPS,
                   1.0 / clip[v][..., 3], 0.0)  # [H,W,3]
    b1 = vis.bary[..., 0]
    b2 = vis.bary[..., 1]
    b0 = 1.0 - b1 - b2
    wgt = jnp.stack([b0, b1, b2], -1) * iw     # [H,W,3]
    denom = jnp.sum(wgt, -1, keepdims=True)
    wgt = wgt / jnp.where(jnp.abs(denom) > _W_EPS, denom, 1.0)
    a = attrs[v]                        # [H,W,3,A]
    out = jnp.einsum("hwk,hwka->hwa", wgt, a)
    return jnp.where((vis.tri >= 0)[..., None], out, 0.0)
