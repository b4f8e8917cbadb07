"""Stage K2 — the blockwise multi-order least-squares fit.

Batched redesign of ``fitter`` (opencl/bmfr.cl:490-700). The reference runs one
256-thread workgroup per 32x32 block, doing (a) per-block min/max feature
scaling, (b) an in-place Householder QR of the 1024x13 block matrix with
hand-unrolled local-memory reduction trees, and (c) a back substitution on a
packed R to get 10 regression weights x 3 color channels per block.

Here the same math is *batched linear algebra* over all blocks at once:

* scaling = batched min/max reductions over ``[n_blocks, F, 1024]``;
* the QR = ``feature_count`` Householder reflection steps, each one a batched
  mat-vec + rank-1 update over the whole ``[n_blocks, 13, 1024]`` tensor
  (the color columns ride along exactly like the reference's, which treats
  them as virtual column 10, opencl/bmfr.cl:606-655);
* back substitution = one batched triangular solve.

The reference's cross-color reflections (cols 10..12 reflecting cols 11..12,
opencl/bmfr.cl:549 with ``limit = buffers``) only modify rows >= 10 of the
color columns, which the back substitution never reads — so they are skipped
here; this is validated against the literal oracle in
``tests/test_pipeline_vs_oracle.py`` and ``tests/test_config_sweeps.py``.

The deterministic regularization noise (opencl/bmfr.cl:625-627) is applied
to feature columns 1..F-1 up front: with the default CACHE_TMP_DATA=1 the
reference noises each column exactly once, while loading it for the col-0
reflection, which is equivalent.

An alternative "cholesky" solver forms the normal equations with a single
batched matmul — mathematically the same least-squares solution, much
cheaper, at some conditioning risk (kept in check by the noise + per-block
scaling). Both are exposed via ``BMFRConfig.solver``.
"""

from __future__ import annotations

import jax.lax as lax
import jax.numpy as jnp

from ..rng import feature_noise


def scale_blocks(cfg, data):
    """Per-block min/max rescale of the scaled features
    (opencl/bmfr.cl:511-542; ``scale`` at :200-205).

    data: ``f32[n_blocks, buffer_count, block_pixels]``.
    Returns (scaled data, mins_maxs ``f32[n_blocks, n_scaled, 2]``).
    """
    lo = cfg.features_not_scaled_count
    hi = cfg.feature_count
    sub = data[:, lo:hi, :]
    bmin = sub.min(axis=-1)
    bmax = sub.max(axis=-1)
    denom = jnp.where(jnp.abs(bmax - bmin) > 1.0, bmax - bmin, 1.0)
    scaled = (sub - bmin[..., None]) / denom[..., None]
    data = data.at[:, lo:hi, :].set(scaled)
    mins_maxs = jnp.stack([bmin, bmax], axis=-1)
    return data, mins_maxs


def scale_with_mins_maxs(values, bmin, bmax):
    """Apply the conditional rescale with precomputed per-block min/max
    (used by the reconstruction, opencl/bmfr.cl:737-741)."""
    denom = jnp.where(jnp.abs(bmax - bmin) > 1.0, bmax - bmin, 1.0)
    return (values - bmin) / denom


def _storage_roundtrip(cfg, x):
    if cfg.tmp_data_dtype != "float32":
        return x.astype(cfg.tmp_data_dtype).astype(jnp.float32)
    return x


def householder_qr_weights(cfg, data):
    """Batched Householder QR + triangular solve.

    data: ``f32[n_blocks, buffer_count, block_pixels]``, feature rows first,
    color rows last, already scaled and noised.
    Returns weights ``f32[n_blocks, feature_count, 3]``.
    """
    F = cfg.feature_count
    B = cfg.buffer_count
    bp = cfg.block_pixels
    elem = jnp.arange(bp)

    T = data
    for col in range(F):
        v = T[:, col, :]                         # [nb, bp]
        tail = jnp.where(elem[None, :] > col, v, 0.0)
        sigma = jnp.sum(tail * tail, axis=-1)    # [nb]
        pivot = v[:, col]
        # vec_length = sqrt(sigma + pivot^2) (opencl/bmfr.cl:583)
        vec_len = jnp.sqrt(sigma + pivot * pivot)
        head = pivot - vec_len
        u_len_sq = sigma + head * head           # [nb]
        u = tail.at[:, col].set(head)            # masked Householder vector

        # Reflect the trailing columns (features col+1.. and all colors).
        rest = T[:, col + 1:, :]                 # [nb, B-col-1, bp]
        dots = jnp.einsum("be,bfe->bf", u, rest,
                          precision=lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
        coef = 2.0 / u_len_sq
        rest = rest - coef[:, None, None] * dots[:, :, None] * u[:, None, :]
        rest = _storage_roundtrip(cfg, rest)

        # Column col becomes (r_0..r_{col-1}, vec_length, 0...) exactly,
        # matching the explicit r_value stores (opencl/bmfr.cl:574-594).
        new_col = jnp.where(elem[None, :] < col, v, 0.0)
        new_col = new_col.at[:, col].set(vec_len)
        T = jnp.concatenate(
            [T[:, :col, :], new_col[:, None, :], rest], axis=1)

    # R is rows 0..F-1 of the feature columns; rhs rows 0..F-1 of colors.
    # (The packed-R store, opencl/bmfr.cl:596-600.)
    R = T[:, :F, :F]                  # [nb, col, elem] -> needs transpose
    R = jnp.swapaxes(R, 1, 2)         # [nb, elem(row), col] upper-triangular
    rhs = jnp.swapaxes(T[:, F:B, :F], 1, 2)   # [nb, row, 3]
    R = jnp.triu(R)
    weights = lax.linalg.triangular_solve(
        R, rhs, left_side=True, lower=False)
    return weights


def cholesky_weights(cfg, data):
    """Normal-equations solve: one batched matmul + Cholesky.

    Mathematically the same least-squares solution as the QR path; offered
    as the high-throughput solver (``BMFRConfig.solver = "cholesky"``).
    """
    F = cfg.feature_count
    A = data[:, :F, :]                 # [nb, F, bp]
    Bc = data[:, F:, :]                # [nb, 3, bp]
    G = jnp.einsum("bfe,bge->bfg", A, A,
                   precision=lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)
    c = jnp.einsum("bfe,bce->bfc", A, Bc,
                   precision=lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)
    L = jnp.linalg.cholesky(G)
    y = lax.linalg.triangular_solve(L, c, left_side=True, lower=True)
    return lax.linalg.triangular_solve(
        L, y, left_side=True, lower=True, transpose_a=True)


def fit_blocks(cfg, tmp_blocks, frame):
    """Full fitter stage: scale -> noise -> solve.

    tmp_blocks: ``[n_blocks, buffer_count, block_pixels]`` in the storage
    dtype produced by :func:`bmfr_tpu.ops.blockify.build_feature_blocks`.
    Returns (weights ``f32[n_blocks, F, 3]``, mins_maxs
    ``f32[n_blocks, n_scaled, 2]``).
    """
    data = tmp_blocks.astype(jnp.float32)
    data, mins_maxs = scale_blocks(cfg, data)
    data = _storage_roundtrip(cfg, data)

    noise = feature_noise(frame, cfg.feature_count, cfg.block_pixels,
                          cfg.buffer_count, cfg.noise_amount)
    data = data.at[:, : cfg.feature_count, :].add(noise[None])

    if cfg.solver == "cholesky":
        weights = cholesky_weights(cfg, data)
    else:
        weights = householder_qr_weights(cfg, data)
    # Singular blocks (NaN) fall back to zero weights; the regularization
    # noise makes this vanishingly rare.
    return jnp.where(jnp.isnan(weights), 0.0, weights), mins_maxs
