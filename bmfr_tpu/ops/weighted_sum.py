"""Stage K3 — weighted-sum reconstruction from the fitted block weights.

Redesign of ``weighted_sum`` (opencl/bmfr.cl:703-758). The reference
recomputes the feature vector per pixel, rescales with its block's min/max,
and dots it with the block's weights, finding the block by inverting the
jitter per pixel (opencl/bmfr.cl:718-722).

Here the per-pixel block lookup disappears: the image's feature planes are
laid out in the *same* jittered block structure as the fit input (one shared
blockify), so the reconstruction becomes one batched ``[block_pixels, F] x
[F, 3]`` matmul per block, followed by the inverse-jitter window
slice. No gathers, no divergent lookups; block membership is by construction
identical to the fit (same mapping ``g = p + half - offset``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..features import evaluate_features
from .blockify import blockify_planes, unblockify_planes
from .fitter import scale_with_mins_maxs


def weighted_sum(cfg, weights, mins_maxs, normals, positions, noisy, frame,
                 feature_blocks=None):
    """Reconstruct the filtered image.

    weights: ``f32[n_blocks, F, 3]``; mins_maxs: ``f32[n_blocks, n_sc, 2]``;
    normals/positions/noisy: ``f32[3, H, W]`` (noisy is the debug bypass
    source, opencl/bmfr.cl:752-754).
    Returns ``f32[3, H, W]`` filtered color, negatives clamped to 0
    (opencl/bmfr.cl:750).

    ``feature_blocks``: optionally the fit input blocks from
    :func:`bmfr_tpu.ops.blockify.build_feature_blocks` — their unscaled
    feature rows are exactly the basis K3 would rebuild (the reference
    recomputes per pixel instead, opencl/bmfr.cl:724-729), so the
    orchestrator passes them to skip a second blockify. Only valid with
    float32 storage (reduced-precision tmp rounds the features; the
    reference's K3 reads raw f32 buffers).
    """
    if feature_blocks is not None and cfg.tmp_data_dtype == "float32":
        fblocks = feature_blocks[:, : cfg.feature_count, :]
    else:
        feats = evaluate_features(cfg.all_features, normals, positions)
        fblocks = blockify_planes(cfg, feats, frame)  # [nb, F, bp]

    lo = cfg.features_not_scaled_count
    scaled = scale_with_mins_maxs(
        fblocks[:, lo:, :], mins_maxs[..., 0:1], mins_maxs[..., 1:2])
    fblocks = jnp.concatenate([fblocks[:, :lo, :], scaled], axis=1)

    # HIGHEST precision: a reduced-precision (bf16/TF32) product costs
    # ~1e-3 absolute error on O(1) colors, far above the fidelity budget.
    color_blocks = jnp.einsum(
        "bfe,bfc->bce", fblocks, weights,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)          # [nb, 3, bp]
    color = unblockify_planes(cfg, color_blocks, frame, 3)
    color = jnp.maximum(color, 0.0)

    if cfg.skip_fitting:
        color = noisy
    return color
