"""Isolate the cost of the 16-part textured scene at 1080p against the
2-part atlas on the GPU: is it per-part overhead, or the locality of gathers
on a ~290 MB atlas?

Variants (same 16-part model, same windowed deferred-UV albedo path):
  a) realistic 2048^2-heavy mix  (~18M texels, ~290 MB packed)
  b) all-256^2 mix               (~1M texels, ~17 MB packed)
  c) 2-part 1024/256 on the 16-part model (parts share textures? no — just
     the 2-part model for reference)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    from simple_mmd_renderer.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from simple_mmd_renderer.app.sample import (realistic_texture_sizes,
                                                    sample_character,
                                                    sample_textures)
    from simple_mmd_renderer.config import RenderConfig
    from simple_mmd_renderer.core import model as model_mod
    from simple_mmd_renderer.core import pose as pose_mod
    from simple_mmd_renderer.render.pipeline import (build_packed_atlas,
                                                         render_frame)

    from simple_mmd_renderer.utils.device import describe
    print(describe(), flush=True)
    density = 2.0
    w, h = 1920, 1080
    n = 30

    def deformed(pm):
        static = model_mod.build_model(pm)
        b = static.n_bones
        rot = jnp.broadcast_to(jnp.asarray([0, 0, 0, 1.0], jnp.float32),
                               (b, 4))
        trans = jnp.zeros((b, 3), jnp.float32)
        rates = jnp.zeros((static.n_morphs,), jnp.float32)
        pose = pose_mod.pre_physics_posing(static, rot, trans, rates)
        positions, normals = pose_mod.deform(static, pose)
        return static, positions, normals

    def run(label, static, positions, normals, textures, mips=0,
            resident=0):
        atlas = build_packed_atlas(textures, mip_levels=mips) \
            if textures else None
        if atlas is not None:
            d = atlas.data
            print(f"  atlas {d.shape} {d.dtype} ~ "
                  f"{d.size * d.dtype.itemsize / 1e6:.0f} MB", flush=True)
        cfg = RenderConfig(width=w, height=h, shadow_map_size=2048,
                           show_skybox=False, texture_mips=mips,
                           texture_resident=resident)

        def body(atl, c, i):
            img = render_frame(static, positions + 0.001 * i, normals, cfg,
                               part_textures=textures, atlas=atl)
            return c + jnp.mean(img), None

        # the atlas rides as a jit ARGUMENT (like Scene.jit_rollout), not
        # as a constant baked into the program
        roll = jax.jit(lambda atl: jax.lax.scan(
            lambda c, i: body(atl, c, i), jnp.float32(0.0),
            jnp.arange(n, dtype=jnp.float32))[0])
        float(roll(atlas))
        t0 = time.time()
        float(roll(atlas))
        ms = (time.time() - t0) / n * 1000.0
        print(f"{label:46s} {ms:7.2f} ms/frame", flush=True)
        return ms

    st16, p16, n16 = deformed(sample_character(density=density, n_parts=16))
    st2, p2, n2 = deformed(sample_character(density=density))

    base = run("16-part untextured", st16, p16, n16, None)
    big = run("16-part realistic 2048-heavy mix", st16, p16, n16,
              sample_textures(realistic_texture_sizes(16)))
    mip = run("16-part realistic mix + texture_mips=6", st16, p16, n16,
              sample_textures(realistic_texture_sizes(16)), mips=6)
    for slot in (128, 256, 384):
        run(f"16-part realistic mix + resident slot={slot}", st16, p16, n16,
            sample_textures(realistic_texture_sizes(16)), mips=6,
            resident=slot)
    res2 = run("2-part 1024/256 + resident slot=256", st2, p2, n2,
               sample_textures(), mips=6, resident=256)
    small = run("16-part all-256^2", st16, p16, n16,
                sample_textures((256,) * 16))
    two = run("2-part 1024/256 (reference point)", st2, p2, n2,
              sample_textures())
    print(f"-> per-part overhead (small16 - 2part): {small - two:.2f} ms; "
          f"atlas-size cost (big16 - small16): {big - small:.2f} ms; "
          f"mips recover: {big - mip:.2f} ms; "
          f"texture cost over untextured: {big - base:.2f} ms", flush=True)


if __name__ == "__main__":
    main()
