"""VMD cubic-Bezier easing curves.

The reference (libmmd `util/math.inl:446-461`, `util/math_impl.inl:1350-1428`)
evaluates VMD interpolation curves through a 32-sample presampled LUT built with
a 32-iteration bisection solve of x(t) = x, then lerps the LUT at runtime. We
reproduce exactly that:

- `presample` (host/NumPy, load time): bisection solve -> float32 LUT[32], plus
  the linear fast-path flag (`c0.x == c0.y and c1.x == c1.y`).
- `lut_eval` (device/jnp, runtime): LUT lerp, identical to `Bezier::operator[]`.

Control points come from VMD int8 bytes scaled by 1/127
(`reader/vmd_reader_impl.inl:26-62`).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

RESOLUTION = 32
_EPS = 1e-8


def _interpolate_scalar(c0x3, c0y3, c1x3, c1y3, x):
    """Exact eval: 32-iteration bisection for t given x, then y(t).

    Arguments are the 3x-scaled control coordinates (the reference stores
    c*3). Cubic with P0=(0,0), P3=(1,1): B(t) = t*((1-t)*((1-t)*3c + t*3c') + t^2).
    """
    l, r = np.float32(0.0), np.float32(1.0)
    lm = np.float32(0.0)
    for _ in range(32):
        lm = np.float32((l + r) * 0.5)
        rm = np.float32(1.0 - lm)
        m = np.float32(lm * (rm * (rm * c0x3 + lm * c1x3) + lm * lm))
        if abs(m - x) < _EPS:
            break
        if m > x:
            r = lm
        else:
            l = lm
    rm = np.float32(1.0 - lm)
    return np.float32(lm * (rm * (rm * c0y3 + lm * c1y3) + lm * lm))


def presample(c0: np.ndarray, c1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Presample a batch of curves.

    c0, c1: float32 [..., 2] control points in [0,1]-ish space (already /127).
    Returns (lut [..., 32] float32, is_linear [...] bool). For linear curves the
    LUT rows are filled with the identity ramp so `lut_eval` needs no flag.
    """
    c0 = np.asarray(c0, np.float32)
    c1 = np.asarray(c1, np.float32)
    batch = c0.shape[:-1]
    flat0 = c0.reshape(-1, 2)
    flat1 = c1.reshape(-1, 2)
    n = flat0.shape[0]
    lut = np.empty((n, RESOLUTION), np.float32)
    linear = (flat0[:, 0] == flat0[:, 1]) & (flat1[:, 0] == flat1[:, 1])
    ramp = (np.arange(RESOLUTION, dtype=np.float32) / np.float32(RESOLUTION - 1))
    xs = ramp
    for i in range(n):
        if linear[i]:
            lut[i] = ramp
        else:
            c0x3, c0y3 = np.float32(flat0[i, 0] * 3), np.float32(flat0[i, 1] * 3)
            c1x3, c1y3 = np.float32(flat1[i, 0] * 3), np.float32(flat1[i, 1] * 3)
            for j, x in enumerate(xs):
                lut[i, j] = _interpolate_scalar(c0x3, c0y3, c1x3, c1y3, x)
    return lut.reshape(batch + (RESOLUTION,)), linear.reshape(batch)


LINEAR_LUT = np.arange(RESOLUTION, dtype=np.float32) / np.float32(RESOLUTION - 1)


def lut_eval(lut, x):
    """Evaluate LUT(s) at x — `Bezier::operator[]` (math_impl.inl:1398-1408).

    lut: [..., 32]; x: [...] broadcastable to lut's batch. Linear curves must
    hold the identity ramp (see `presample`), which makes this exact for them
    because lerping a ramp reproduces x.
    """
    x = jnp.asarray(x, lut.dtype)
    xs = x * (RESOLUTION - 1)
    ix = jnp.clip(xs.astype(jnp.int32), 0, RESOLUTION - 1)
    r = xs - ix.astype(lut.dtype)
    # one-hot contraction instead of take_along_axis: identical arithmetic
    # ((1-r)*lut[ix] + r*lut[ix+1]) as selects and sums over the 32 samples
    # (the gather form compiled far slower). At ix==31 both
    # weights land on the last sample, matching the reference's tail branch.
    j = jnp.arange(RESOLUTION, dtype=jnp.int32)
    shape = jnp.broadcast_shapes(lut.shape[:-1], ix.shape)
    ixb = jnp.broadcast_to(ix, shape)[..., None]
    rb = jnp.broadcast_to(r, shape)[..., None]
    w = (jnp.where(j == ixb, 1.0 - rb, 0.0)
         + jnp.where(j == jnp.minimum(ixb + 1, RESOLUTION - 1), rb, 0.0))
    return jnp.sum(jnp.broadcast_to(lut, shape + (RESOLUTION,)) * w, -1)
