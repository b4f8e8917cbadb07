"""Fused K2+K3 for the GPU: one Pallas (Triton) program per fitting block.

The XLA path (:mod:`bmfr_tpu.ops.blockify`, :mod:`bmfr_tpu.ops.fitter`,
:mod:`bmfr_tpu.ops.weighted_sum`) materializes the blocked feature tensor
``[n_blocks, 13, block_pixels]`` in device memory, rescales it, and runs the
Householder QR as ``feature_count`` batched reflections that each rewrite
the trailing columns; the reconstruction then reads the features again.

This kernel follows the reference's own GPU design instead — one
work-group per block with the block's whole QR kept on chip
(``fitter``, opencl/bmfr.cl:490-700) followed by the per-pixel weighted sum
(opencl/bmfr.cl:703-758). Each program:

* loads its block's 9 raw planes (normals, positions, accumulated color)
  straight from the mirror-padded image at the per-frame jitter origin
  (the reference's mirrored, jittered addressing, opencl/bmfr.cl:314-316 —
  no jittered copy is made);
* evaluates the feature basis (:data:`bmfr_tpu.features.FEATURE_REGISTRY`)
  and applies the K1 store contract (NaN -> 0, half clamp, storage
  rounding; opencl/bmfr.cl:447-476);
* rescales with the block's min/max (opencl/bmfr.cl:511-542) and adds the
  regularization noise (opencl/bmfr.cl:625-627);
* solves the least-squares fit — Householder QR as ``feature_count``
  static reflections with the storage rounding after each one
  (opencl/bmfr.cl:549-656), or the normal equations with a scalar
  Cholesky factorization and two substitutions;
* reconstructs the filtered color of its block and stores it in the
  jittered margins-grid layout. The caller slices the image back out with
  the inverse jitter (opencl/bmfr.cl:718-722).

Every reduction is an element-wise f32 product summed with ``jnp.sum`` —
never ``pl.dot``, whose TF32 inputs would lose the mantissa the normal
equations need. Semantics equal the XLA path's (same scale conditional,
noise-once rule, reflection order, rounding points, NaN -> zero weights),
which ``tests/test_fitter_fused.py`` pins.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..config import FUSED_BLOCK_EDGES
from ..features import FEATURE_REGISTRY
from ..rng import feature_noise
from .blockify import blockify_padded, jitter_offset, jitter_origin

#: warps per program: a 32x32 block's 13 f32 columns (52 KB) spread over
#: 256 threads keep ~52 registers per thread for the block itself
NUM_WARPS = 8


def _store(cfg, x):
    """Storage round trip of the reduced-precision ``tmp_data`` store
    (opencl/bmfr.cl:255-265)."""
    if cfg.tmp_data_dtype == "float32":
        return x
    return x.astype(cfg.tmp_data_dtype).astype(jnp.float32)


def _pick(mask, x):
    """The single element of ``x`` selected by ``mask``, as a scalar."""
    return jnp.sum(jnp.where(mask, x, 0.0))


def _features(cfg, load):
    """Feature planes of one block from the raw normals/positions."""
    n3 = [load(0), load(1), load(2)]
    p3 = [load(3), load(4), load(5)]
    return [FEATURE_REGISTRY[name](n3, p3) for name in cfg.all_features]


def _householder(cfg, cols, elem):
    """Householder QR + back substitution on one block
    (opencl/bmfr.cl:549-699). ``cols``: the ``buffer_count`` scaled,
    noised columns. Returns weights ``w[f][ch]`` as scalars."""
    F, B = cfg.feature_count, cfg.buffer_count
    cols = list(cols)
    diag = []
    for col in range(F):
        v = cols[col]
        tail = jnp.where(elem > col, v, 0.0)
        sigma = jnp.sum(tail * tail)
        pivot = _pick(elem == col, v)
        vec_len = jnp.sqrt(sigma + pivot * pivot)
        head = pivot - vec_len
        coef = 2.0 / (sigma + head * head)
        u = jnp.where(elem == col, head, tail)
        for j in range(col + 1, B):
            d = jnp.sum(u * cols[j])
            cols[j] = _store(cfg, cols[j] - (coef * d) * u)
        diag.append(vec_len)
    # R's strict upper triangle and the rhs sit in the first F elements
    # of the reflected columns (reflection k leaves elements < k alone)
    def r(row, c):
        return diag[row] if row == c else _pick(elem == row, cols[c])

    w = [[None] * 3 for _ in range(F)]
    for ch in range(3):
        for c in reversed(range(F)):
            acc = r(c, F + ch)
            for c2 in range(c + 1, F):
                acc = acc - r(c, c2) * w[c2][ch]
            w[c][ch] = acc / diag[c]
    return w


def _cholesky(cfg, cols):
    """Normal-equations solve on one block: Gram + rhs as exact f32 sums,
    a scalar Cholesky factorization and two substitutions
    (:func:`bmfr_tpu.ops.fitter.cholesky_weights` semantics)."""
    F = cfg.feature_count
    G = {}
    for i in range(F):
        for j in range(i, F + 3):
            G[i, j] = jnp.sum(cols[i] * cols[j])
    L = {}
    for j in range(F):
        d = G[j, j]
        for k in range(j):
            d = d - L[j, k] * L[j, k]
        L[j, j] = jnp.sqrt(d)
        for i in range(j + 1, F):
            v = G[j, i]
            for k in range(j):
                v = v - L[i, k] * L[j, k]
            L[i, j] = v / L[j, j]
    w = [[None] * 3 for _ in range(F)]
    for ch in range(3):
        y = [None] * F
        for i in range(F):
            v = G[i, F + ch]
            for k in range(i):
                v = v - L[i, k] * y[k]
            y[i] = v / L[i, i]
        for i in reversed(range(F)):
            v = y[i]
            for k in range(i + 1, F):
                v = v - L[k, i] * w[k][ch]
            w[i][ch] = v / L[i, i]
    return w


def _kernel(cfg, org_ref, src_ref, noise_ref, out_ref):
    F = cfg.feature_count
    lo = cfg.features_not_scaled_count
    be = cfg.block_edge
    by = pl.program_id(0)
    bx = pl.program_id(1)
    y0 = org_ref[0] + by * be
    x0 = org_ref[1] + bx * be

    def load(c):
        return src_ref[c, pl.ds(y0, be), pl.ds(x0, be)]

    # K1 feature build + store contract (opencl/bmfr.cl:447-476)
    feats = _features(cfg, load)
    cols = feats + [load(6), load(7), load(8)]
    cols = [jnp.where(jnp.isnan(x), 0.0, x) for x in cols]
    if cfg.tmp_data_dtype == "float16":
        cols = [jnp.clip(x, -65504.0, 65504.0) for x in cols]
    cols = [_store(cfg, x) for x in cols]

    # per-block min/max rescale (opencl/bmfr.cl:511-542), storage
    # rounding, then the regularization noise (opencl/bmfr.cl:625-627)
    lims = []
    for f in range(lo, F):
        bmin = jnp.min(cols[f])
        bmax = jnp.max(cols[f])
        denom = jnp.where(jnp.abs(bmax - bmin) > 1.0, bmax - bmin, 1.0)
        lims.append((bmin, denom))
        cols[f] = (cols[f] - bmin) / denom
    cols = [_store(cfg, x) for x in cols]
    for f in range(1, F):
        cols[f] = cols[f] + noise_ref[f, :, :]

    if cfg.solver == "cholesky":
        w = _cholesky(cfg, cols)
    else:
        row = jax.lax.broadcasted_iota(jnp.int32, (be, be), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (be, be), 1)
        w = _householder(cfg, cols, row * be + col)
    # singular blocks (NaN) fall back to zero weights
    w = [[jnp.where(jnp.isnan(x), 0.0, x) for x in wf] for wf in w]

    # K3 (opencl/bmfr.cl:724-747): the reference recomputes the features
    # per pixel from the raw f32 buffers and rescales with K2's min/max;
    # under float32 storage that basis is the (NaN-sanitized) store itself
    basis = _features(cfg, load)
    if cfg.tmp_data_dtype == "float32":
        basis = [jnp.where(jnp.isnan(x), 0.0, x) for x in basis]
    for f in range(lo, F):
        bmin, denom = lims[f - lo]
        basis[f] = (basis[f] - bmin) / denom
    for ch in range(3):
        color = basis[0] * w[0][ch]
        for f in range(1, F):
            color = color + basis[f] * w[f][ch]
        out_ref[ch, pl.ds(by * be, be), pl.ds(bx * be, be)] = jnp.maximum(
            color, 0.0)


def fit_reconstruct_fused(cfg, padded9, origin, frame, interpret=False):
    """Fit every block and reconstruct its filtered color in one kernel.

    padded9: ``f32[9, ., .]`` mirror-padded (normals, positions,
    accumulated color) planes from :func:`blockify_padded`; origin: the
    ``i32[2]`` :func:`jitter_origin` of ``frame``. Returns the filtered
    color in the jittered margins-grid layout ``f32[3, mh, mw]``.
    ``interpret`` runs the kernel in the Pallas interpreter (CPU tests).
    """
    be = cfg.block_edge
    assert be in FUSED_BLOCK_EDGES, be
    F = cfg.feature_count
    noise = feature_noise(frame, F, cfg.block_pixels, cfg.buffer_count,
                          cfg.noise_amount).reshape(F, be, be)
    mh, mw = cfg.workset_with_margins_height, cfg.workset_with_margins_width
    return pl.pallas_call(
        functools.partial(_kernel, cfg),
        out_shape=jax.ShapeDtypeStruct((3, mh, mw), jnp.float32),
        grid=(cfg.blocks_y, cfg.blocks_x),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="bmfr_fused_fit",
    )(origin.astype(jnp.int32), padded9, noise)


def filtered_fused(cfg, normals, positions, accum, frame):
    """K2+K3 through the fused kernel: mirror pad, fit + reconstruct,
    inverse-jitter slice. Returns the filtered color ``f32[3, H, W]``."""
    with jax.named_scope("k2_blockify"):
        padded9 = blockify_padded(
            cfg, jnp.concatenate([normals, positions, accum], axis=0))
    with jax.named_scope("k2_fitter"):
        view = fit_reconstruct_fused(
            cfg, padded9, jitter_origin(cfg, frame), frame,
            interpret=cfg.pallas_interpret)
    with jax.named_scope("k3_weighted_sum"):
        # image pixel (y, x) = view[y + half - off1, x + half - off0]
        # (the unblockify mapping, opencl/bmfr.cl:718-722)
        half = cfg.block_edge // 2
        off = jitter_offset(frame, cfg.block_edge)
        return jax.lax.dynamic_slice(
            view, (jnp.int32(0), half - off[1], half - off[0]),
            (3, cfg.image_height, cfg.image_width))
