"""Golden-frame image regression (r4 VERDICT weak #6).

The render suite asserts properties and cross-path parity (tiled vs scan,
fused vs vmap) — strong against per-path bugs, but a GLOBAL shading drift
(a bent constant in shade_character, a changed tone-map, a broken sRGB
conversion) moves every path together and passes all of it. These tests
render ~6 fixed configs on CPU (exact scan raster, rest pose — no
anim/physics, so the pixels depend only on the render stack) and compare
against committed PNGs with a tolerance that survives cross-version XLA
float reassociation but fails on any deliberate shading change.

Regenerate after an INTENTIONAL change with:
    GOLDEN_REGEN=1 python -m pytest tests/test_golden_frames.py -q
and eyeball the updated PNGs in the diff.

Anchors: shader/main.glsl:89-113 (the formulas a global drift would
silently bend), shader/ground.glsl:83-108, main.cpp:2502-2504.
"""

import os

import numpy as np
import pytest

from simple_mmd_renderer.app.sample import sample_character, sample_textures
from simple_mmd_renderer.config import RenderConfig
from simple_mmd_renderer.core.model import build_model
from simple_mmd_renderer.render.pipeline import render_frame
from simple_mmd_renderer.render import ibl as ibl_mod

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
W, H = 192, 144
REGEN = os.environ.get("GOLDEN_REGEN", "") == "1"

_CAM = dict(camera_pos=np.array([0.0, 1.2, -2.6], np.float32),
            camera_target=np.array([0.0, 0.9, 0.0], np.float32))


def _static():
    return build_model(sample_character(density=0.5))


def _mmd_maps(static):
    """Synthetic toon ramps + sphere maps (deterministic, no files)."""
    pn = len(static.part_base)
    k = 16
    ramps = np.ones((pn, k, 3), np.float32)
    ramp = np.linspace(1.0, 0.55, k, dtype=np.float32)
    ramps[:, :, :] = ramp[None, :, None]
    ys = np.linspace(0.6, 1.0, 32, dtype=np.float32)
    sph = np.broadcast_to(ys[:, None, None], (32, 32, 3)).copy()
    texs = [sph for _ in range(pn)]
    modes = np.zeros(pn, np.int32)
    modes[0] = 1   # SPH multiply on the first part
    return texs, modes, ramps


def _cubemap():
    """Tiny synthetic equirect -> cubemap (exercises the IBL path)."""
    h, w = 16, 32
    eq = np.zeros((h, w, 3), np.float32)
    eq[:, :, 0] = np.linspace(0.1, 1.2, w, dtype=np.float32)[None, :]
    eq[:, :, 1] = np.linspace(1.0, 0.1, h, dtype=np.float32)[:, None]
    eq[:, :, 2] = 0.4
    import jax.numpy as jnp
    return ibl_mod.equirect_to_cubemap(jnp.asarray(eq), 32)


def _render(name):
    static = _static()
    pos = np.asarray(static.positions, np.float32)
    nrm = np.asarray(static.normals, np.float32)
    kw = {}
    cfg_kw = dict(width=W, height=H, shadow_map_size=128,
                  show_skybox=False, **_CAM)
    if name == "textured":
        kw["part_textures"] = sample_textures((128, 64))
    elif name == "msaa4":
        cfg_kw["msaa"] = 4
    elif name == "toon_sph":
        kw["part_textures"] = sample_textures((128, 64))
        kw["mmd_maps"] = _mmd_maps(static)
    elif name == "edges":
        cfg_kw["show_edges"] = True
    elif name == "double_sided":
        cfg_kw["double_sided"] = True
        static.nocull_tris[: len(static.nocull_tris) // 2] = True
    elif name == "skybox":
        cfg_kw["show_skybox"] = True
        kw["cubemap"] = _cubemap()
    cfg = RenderConfig(**cfg_kw)
    img = render_frame(static, pos, nrm, cfg, **kw)
    return np.asarray(np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255),
                      np.uint8)


CONFIGS = ["flat", "textured", "msaa4", "toon_sph", "edges",
           "double_sided", "skybox"]


@pytest.mark.parametrize("name", CONFIGS)
def test_golden_frame(name):
    from PIL import Image
    path = os.path.join(GOLDEN_DIR, f"{name}.png")
    got = _render(name)
    if REGEN or not os.path.exists(path):
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        Image.fromarray(got).save(path)
        if not REGEN:
            pytest.skip(f"golden {name}.png created — commit it")
        return
    want = np.asarray(Image.open(path).convert("RGB"))
    assert want.shape == got.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    mean = diff.mean()
    frac_big = (diff.max(-1) > 8).mean()
    # tolerant to float reassociation (sub-quantization wiggle on a few
    # pixels), hard-fails on any real shading drift: a 1% change to the
    # diffuse/rim/specular constants shifts hundreds of pixels by >8/255
    assert mean < 1.0 and frac_big < 0.002, (
        f"{name}: mean abs diff {mean:.3f}, >8/255 fraction {frac_big:.4f} "
        f"— the shading output drifted; if intentional, regenerate with "
        f"GOLDEN_REGEN=1 and review the image diff")


def test_golden_detects_shading_drift(monkeypatch):
    """Meta-test: a deliberate 5% drift of the shaded character color must
    fail the comparison. (Applied to the OUTPUT, not the albedo: the flat
    config's white character saturates, so small albedo-side drifts clip
    away — exactly why the textured/toon configs are in the set too.)"""
    from PIL import Image
    path = os.path.join(GOLDEN_DIR, "textured.png")
    if not os.path.exists(path):
        pytest.skip("golden textured.png not generated yet")
    want = np.asarray(Image.open(path).convert("RGB"))
    from simple_mmd_renderer.render import shade
    orig = shade.shade_character

    def drifted(albedo, *a, **k):
        return orig(albedo, *a, **k) * 0.95

    monkeypatch.setattr(shade, "shade_character", drifted)
    got = _render("textured")
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert not (diff.mean() < 1.0 and (diff.max(-1) > 8).mean() < 0.002), \
        "a 5% shading drift must trip the golden comparison"
