"""Bilinear gather utilities for the temporal reprojection stages.

The reference does per-pixel bilinear taps with branchy bounds/validity tests
(opencl/bmfr.cl:374-419, :801-832, :929-960). The formulation here is
branch-free: indices are clipped, values gathered for all pixels, and
validity folded in as multiplicative masks.
"""

from __future__ import annotations

import jax.numpy as jnp

#: Tap offsets in reference order; the accept bitmask assigns bit ``i`` to
#: ``TAP_OFFSETS[i]`` (opencl/bmfr.cl:359-363, :801-832).
TAP_OFFSETS = ((0, 0), (1, 0), (0, 1), (1, 1))


def floor_int(x):
    """convert_int2_rtn: round toward negative infinity (opencl/bmfr.cl:356)."""
    return jnp.floor(x).astype(jnp.int32)


def gather_planes(planes, yi, xi):
    """Gather ``planes[..., yi, xi]`` with clipped indices.

    planes: ``[C, H, W]`` (or ``[H, W]``); yi/xi: int32 ``[H, W]`` index maps.
    Out-of-range indices are clipped — mask separately with
    :func:`in_bounds`.
    """
    H, W = planes.shape[-2:]
    yc = jnp.clip(yi, 0, H - 1)
    xc = jnp.clip(xi, 0, W - 1)
    return planes[..., yc, xc]


def in_bounds(yi, xi, H, W):
    """Screen-bounds validity of a tap (opencl/bmfr.cl:380-381)."""
    return (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)


def bilinear_weights(fx, fy):
    """The four bilinear weights in reference tap order
    (opencl/bmfr.cl:366-370)."""
    return (
        (1.0 - fx) * (1.0 - fy),
        fx * (1.0 - fy),
        (1.0 - fx) * fy,
        fx * fy,
    )
