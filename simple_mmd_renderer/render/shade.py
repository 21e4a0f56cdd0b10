"""Deferred shading: the reference's GLSL fragment programs as jnp functions.

- `shade_character`: `shader/main.glsl:79-118` — albedo texture, rim light
  `(1-N·V)^rim_power`, Blinn-Phong specular gated on N·L, fixed 0.25 weak
  diffuse, final `albedo*(0.9+diffuse)+rim+spec`, then the shader's
  srgb->linear transfer applied to the final color.
- `shade_ground`: `shader/ground.glsl:55-125` — albedo*0.7 times a 3x3 PCF
  shadow factor from the light-space depth map.
- `tonemap_aces` + skybox sampling live in render/ibl.py.
"""

from __future__ import annotations

import jax.numpy as jnp


def srgb_to_linear(c):
    """SrgbToLinear (main.glsl:64-77) — applied to the *final* color."""
    return jnp.where(c <= 0.04045, c / 12.92,
                     jnp.power(jnp.abs((c + 0.055) / 1.055), 2.4))


def linear_to_srgb(c):
    return jnp.where(c <= 0.0031308, 12.92 * c,
                     1.055 * jnp.power(jnp.abs(c), 1.0 / 2.4) - 0.055)


def _normalize(v, axis=-1):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=axis, keepdims=True), 1e-12)


def shade_character(albedo, normal, world_pos, view_pos, cfg):
    """albedo/normal/world_pos: [...,3]; cfg: RenderConfig-like with light and
    material fields. Returns linear-ish final color per main.glsl.

    Evaluated PLANAR (per-channel [H,W] planes): XLA fuses the channel
    slices into the producers, so the only [...,3] materialization left is
    the final stack."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    nn = jnp.maximum(jnp.sqrt(nx * nx + ny * ny + nz * nz), 1e-12)
    nx, ny, nz = nx / nn, ny / nn, nz / nn
    vx = view_pos[0] - world_pos[..., 0]
    vy = view_pos[1] - world_pos[..., 1]
    vz = view_pos[2] - world_pos[..., 2]
    vn = jnp.maximum(jnp.sqrt(vx * vx + vy * vy + vz * vz), 1e-12)
    vx, vy, vz = vx / vn, vy / vn, vz / vn
    l = _normalize(-jnp.asarray(cfg.light_direction, jnp.float32))

    ndotv = jnp.maximum(nx * vx + ny * vy + nz * vz, 0.0)
    rim_factor = jnp.power(jnp.abs(1.0 - ndotv), cfg.rim_power)

    hx, hy, hz = vx + l[0], vy + l[1], vz + l[2]
    hinv = 1.0 / jnp.maximum(jnp.sqrt(hx * hx + hy * hy + hz * hz), 1e-12)
    ndoth = jnp.maximum((nx * hx + ny * hy + nz * hz) * hinv, 0.0)
    ndotl = jnp.maximum(nx * l[0] + ny * l[1] + nz * l[2], 0.0)
    spec_factor = jnp.where(ndotl > 0.0,
                            jnp.power(jnp.abs(ndoth), cfg.specular_power),
                            0.0)
    light_col = jnp.asarray(cfg.light_color, jnp.float32) * cfg.light_intensity
    rim_col = jnp.asarray(cfg.rim_color, jnp.float32) * cfg.rim_intensity

    chans = []
    for c in range(3):
        final = (albedo[..., c] * (0.9 + light_col[c] * 0.25 * ndotl)
                 + rim_col[c] * rim_factor
                 + light_col[c] * cfg.specular_intensity * spec_factor)
        chans.append(srgb_to_linear(final))
    return jnp.stack(chans, -1)


def pcf_shadow(light_space_pos, shadow_map, enabled, bias=0.001):
    """3x3 PCF (ground.glsl:66-125). light_space_pos: [...,4] clip coords in
    the light frustum; shadow_map: [S,S] depth. Returns [...,1] shadow factor
    in [0,1] (1 = fully lit)."""
    s = shadow_map.shape[0]
    w = light_space_pos[..., 3:4]
    proj = light_space_pos[..., :3] / jnp.where(jnp.abs(w) > 1e-9, w, 1.0)
    proj = proj * 0.5 + 0.5
    # the shadow map was rendered y-down like every raster pass here; the
    # GL-style [0,1] y must flip to row index (ground.glsl:74-79 d3d branch)
    u = proj[..., 0]
    v_ = 1.0 - proj[..., 1]
    # RH_ZO depth is already [0,1]; the GLSL *0.5+0.5 remap cancels against
    # GL's viewport depth remap, so the effective comparison is ZO vs ZO.
    zref = light_space_pos[..., 2] / jnp.where(jnp.abs(w[..., 0]) > 1e-9,
                                               w[..., 0], 1.0)

    inside = ((u >= -0.001) & (u <= 1.001) &
              (v_ >= -0.001) & (v_ <= 1.001) &
              (zref >= 0.0) & (zref <= 1.001))

    uc = jnp.clip(u, 0.0, 1.0)
    vc = jnp.clip(v_, 0.0, 1.0)
    px = jnp.clip((uc * s).astype(jnp.int32), 0, s - 1)
    py = jnp.clip((vc * s).astype(jnp.int32), 0, s - 1)

    total = jnp.zeros_like(zref)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            qx = jnp.clip(px + dx, 0, s - 1)
            qy = jnp.clip(py + dy, 0, s - 1)
            depth = shadow_map[qy, qx]
            total = total + jnp.where(zref - bias < depth, 1.0, 0.0)
    shadow = jnp.clip(total / 9.0, 0.0, 1.0)
    shadow = jnp.where(inside, shadow, 1.0)
    return jnp.where(enabled, shadow, 1.0)[..., None]


def shade_ground(albedo, light_space_pos, shadow_map, shadows_enabled,
                 receive_shadows=True):
    """ground.glsl:118-125: albedo*0.7 times the PCF factor."""
    shadow = pcf_shadow(light_space_pos, shadow_map,
                        shadows_enabled & receive_shadows)
    return albedo * 0.7 * shadow


def _ground_zref_plane(s, light_vp, bias):
    """zref(row, col) = z0 + zc*col + zr*row for the y=0 ground plane seen
    through the (affine, ortho) light VP, with `bias` folded into z0:
    unproject each texel's (u,v) to the plane and evaluate its depth.
    Affine because every step is affine."""
    m = light_vp  # affine: row 3 == (0,0,0,1)
    # solve [m00 m02; m10 m12] @ (px,pz) = (x - t0, y - t1) with py=0
    a, b_ = m[0, 0], m[0, 2]
    c, d = m[1, 0], m[1, 2]
    det = a * d - b_ * c
    det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    i00, i01 = d / det, -b_ / det
    i10, i11 = -c / det, a / det
    du = 2.0 / s                      # d(x_ndc)/d(col)
    dv = -2.0 / s                     # d(y_ndc)/d(row)
    rx0 = (0.5 / s) * 2.0 - 1.0 - m[0, 3]
    ry0 = 1.0 - 2.0 * (0.5 / s) - m[1, 3]
    px0 = i00 * rx0 + i01 * ry0
    pz0 = i10 * rx0 + i11 * ry0
    z0 = m[2, 0] * px0 + m[2, 2] * pz0 + m[2, 3]
    zc = (m[2, 0] * i00 + m[2, 2] * i10) * du
    zr = (m[2, 0] * i01 + m[2, 2] * i11) * dv
    return z0 - bias, zc, zr


def ground_lit_map(shadow_map, light_vp, bias=0.001):
    """3x3 PCF evaluated in SHADOW space for the y=0 ground plane.

    shadow_map: [S,S], or a batch [B,S,S] (the crowd's per-instance maps
    under one light). For every shadow-map texel, unproject its (u,v) to
    the ground plane (the light VP is affine for an ortho light), compute
    the ground's reference depth there, and average the 3x3 comparison —
    no gathers: nine shifted compares that XLA fuses into one elementwise
    pass. The screen pass then needs a single lookup into this lit map
    instead of 9 random gathers per pixel (render/pipeline.py). Differs
    from per-pixel PCF only by sub-texel quantization of the tap centers."""
    s = shadow_map.shape[-1]
    z0, zc, zr = _ground_zref_plane(s, light_vp, bias)
    col = jnp.arange(s, dtype=jnp.float32)[None, :]
    row = jnp.arange(s, dtype=jnp.float32)[:, None]
    zref = z0 + zc * col + zr * row             # bias already folded in
    widths = [(0, 0)] * (shadow_map.ndim - 2) + [(1, 1), (1, 1)]
    pad = jnp.pad(shadow_map, widths, mode="edge")
    total = jnp.zeros_like(shadow_map)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            total = total + jnp.where(
                zref < pad[..., dy:dy + s, dx:dx + s], 1.0, 0.0)
    return jnp.clip(total / 9.0, 0.0, 1.0)


def ground_shadow_lookup(light_space_pos, lit_map, enabled):
    """Single-tap lookup into `ground_lit_map` with the reference's bounds
    fallback (outside the frustum -> fully lit)."""
    s = lit_map.shape[0]
    w = light_space_pos[..., 3]
    wsafe = jnp.where(jnp.abs(w) > 1e-9, w, 1.0)
    u = (light_space_pos[..., 0] / wsafe) * 0.5 + 0.5
    v = 1.0 - ((light_space_pos[..., 1] / wsafe) * 0.5 + 0.5)
    zref = light_space_pos[..., 2] / wsafe
    inside = ((u >= -0.001) & (u <= 1.001) & (v >= -0.001) & (v <= 1.001) &
              (zref >= 0.0) & (zref <= 1.001))
    px = jnp.clip((jnp.clip(u, 0.0, 1.0) * s).astype(jnp.int32), 0, s - 1)
    py = jnp.clip((jnp.clip(v, 0.0, 1.0) * s).astype(jnp.int32), 0, s - 1)
    lit = lit_map[py, px]
    lit = jnp.where(inside, lit, 1.0)
    return jnp.where(enabled, lit, 1.0)[..., None]
