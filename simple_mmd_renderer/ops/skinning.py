"""Skinning as a matrix product: linear-blend skinning as a dense
bone-palette matmul.

The reference's `Poser::Deform` (poser_impl.inl:396-461) is a serial CPU loop
gathering up to 4 bone matrices per vertex. This formulation turns the
scattered gather into matrix multiplication: the static 4-wide weight
table becomes a dense [N, B] weight matrix W (built once at load), and the
per-frame blend is

    blended[N, 12] = W @ palette[B, 12]        (one matrix product)
    pos' = blended_rot @ (pos + morph) + blended_trans   (elementwise, fused)

which is identical arithmetic to the gather path up to float summation order
(the three extra zero weights contribute exact zeros). W defaults to f32 so
the matmul path stays allclose-tight against the 4-wide gather reference
(BASELINE.md: bitwise-stable skinning). Passing dtype=bfloat16 to
`build_weight_matrix` halves the table's HBM footprint and read traffic —
weights round at ~2^-9 relative (PMX stores f32 weights, so bf16 is lossy);
the matmul still accumulates in f32 (the bf16 table upcasts after the HBM
read, fused into the operand load), tested allclose in
tests/test_pose.py::test_matmul_skinning_bf16_weights_close.

Used automatically by `core.pose.deform` when the dense table is affordable
(N*B below a budget); the gather path remains for huge rigs and as the
semantic reference.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def build_weight_matrix(skin_bones: np.ndarray, skin_weights: np.ndarray,
                        n_bones: int, dtype=np.float32) -> np.ndarray:
    """[N,4] sparse tables -> dense [N, B] weight matrix (host, once)."""
    n = skin_bones.shape[0]
    w = np.zeros((n, n_bones), np.float32)
    rows = np.repeat(np.arange(n), 4)
    cols = skin_bones.reshape(-1)
    vals = skin_weights.reshape(-1)
    np.add.at(w, (rows, np.clip(cols, 0, n_bones - 1)), vals)
    return w.astype(dtype)


def skin_matmul(weight_matrix, skin_mats, positions, vertex_offsets, normals):
    """-> (pos' [N,3], nrm' [N,3]).

    weight_matrix: [N,B] (possibly bf16); skin_mats: [B,4,4].

    The blend always accumulates in f32: a bf16 W upcasts after the HBM
    read (XLA fuses the convert into the operand load, so the bandwidth
    saving survives), and the tiny [B,12] palette never downcasts —
    translations can be tens of MMD units, where bf16 loses ~0.05."""
    b = skin_mats.shape[0]
    palette = skin_mats[:, :3, :4].reshape(b, 12).astype(jnp.float32)
    w = jnp.asarray(weight_matrix).astype(jnp.float32)
    blended = jnp.dot(w, palette,
                      preferred_element_type=jnp.float32)   # [N,12]
    m = blended.reshape(-1, 3, 4)
    p = positions + vertex_offsets
    out_pos = jnp.einsum("nij,nj->ni", m[:, :, :3], p) + m[:, :, 3]
    out_nrm = jnp.einsum("nij,nj->ni", m[:, :, :3], normals)
    return out_pos, out_nrm
