import numpy as np
import jax.numpy as jnp

from simple_mmd_renderer.utils import bezier


def _bezier_exact(c0, c1, x, tol=1e-12):
    """Independent oracle: invert x(t) by dense bisection in float64."""
    c0x, c0y = 3.0 * c0[0], 3.0 * c0[1]
    c1x, c1y = 3.0 * c1[0], 3.0 * c1[1]

    def bx(t):
        return t * ((1 - t) * ((1 - t) * c0x + t * c1x) + t * t)

    lo, hi = 0.0, 1.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if bx(mid) > x:
            hi = mid
        else:
            lo = mid
    t = 0.5 * (lo + hi)
    return t * ((1 - t) * ((1 - t) * c0y + t * c1y) + t * t)


def test_linear_flag_and_identity():
    c0 = np.array([[0.25, 0.25]], np.float32)
    c1 = np.array([[0.75, 0.75]], np.float32)
    lut, linear = bezier.presample(c0, c1)
    assert linear[0]
    xs = jnp.linspace(0.0, 0.999, 17)
    np.testing.assert_allclose(
        bezier.lut_eval(jnp.asarray(np.repeat(lut, 17, 0)), xs), xs, atol=1e-6
    )


def test_presample_matches_exact_solver():
    rng = np.random.default_rng(0)
    c0 = rng.uniform(0.0, 1.0, (8, 2)).astype(np.float32)
    c1 = rng.uniform(0.0, 1.0, (8, 2)).astype(np.float32)
    lut, linear = bezier.presample(c0, c1)
    assert not linear.any()
    for i in range(8):
        for j in range(bezier.RESOLUTION):
            x = j / (bezier.RESOLUTION - 1)
            expect = _bezier_exact(c0[i], c1[i], x)
            assert abs(lut[i, j] - expect) < 2e-4, (i, j, lut[i, j], expect)


def test_lut_eval_interpolates():
    c0 = np.array([0.1, 0.9], np.float32)  # strong ease-out
    c1 = np.array([0.2, 1.0], np.float32)
    lut, _ = bezier.presample(c0, c1)
    xs = np.linspace(0, 0.999, 50).astype(np.float32)
    got = np.asarray(bezier.lut_eval(jnp.asarray(np.tile(lut, (50, 1))), jnp.asarray(xs)))
    # piecewise-linear in the LUT: exact at sample points, monotone between
    assert np.all(np.diff(got) >= -1e-6)
    assert got[0] == lut[0]
    np.testing.assert_allclose(got[-1], np.interp(xs[-1] * 31, np.arange(32), lut), atol=1e-5)


def test_endpoint_semantics():
    c0 = np.array([0.9, 0.05], np.float32)
    c1 = np.array([0.95, 0.1], np.float32)
    lut, _ = bezier.presample(c0, c1)
    assert abs(lut[0] - 0.0) < 1e-6
    assert abs(lut[-1] - 1.0) < 1e-6
    # x exactly 1.0 hits the tail branch
    np.testing.assert_allclose(bezier.lut_eval(jnp.asarray(lut), jnp.asarray(1.0)), lut[-1])


def test_vmd_quantization_path():
    raw = np.array([20, 20, 107, 107], np.int8)  # default MMD linear-ish curve
    c0 = raw[:2].astype(np.float32) / 127.0
    c1 = raw[2:].astype(np.float32) / 127.0
    lut, linear = bezier.presample(c0[None], c1[None])
    assert linear[0]  # 20/127==20/127 and 107/127==107/127 -> linear fast path
