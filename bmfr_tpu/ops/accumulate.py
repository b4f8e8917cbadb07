"""Stage K4 — second temporal accumulation + albedo remodulation + tone map.

Redesign of ``accumulate_filtered_data`` (opencl/bmfr.cl:761-857):
branch-free masked bilinear taps reusing the accept bitmask and reprojected
coordinates produced by stage K1, then the dynamically-capped blend, albedo
remodulation and gamma tone map (opencl/bmfr.cl:847-856).
"""

from __future__ import annotations

import jax.numpy as jnp

from .gather import TAP_OFFSETS, bilinear_weights, floor_int


def accumulate_filtered_data(cfg, filtered, prev_pixels, accept, albedo,
                             spp, prev_out, frame, taps=None):
    """Returns (accumulated ``f32[3,H,W]``, tone_mapped ``f32[3,H,W]``).

    filtered: K3 output; prev_pixels ``f32[2,H,W]`` and accept ``u8[H,W]``
    from K1; spp ``u8[H,W]`` current; prev_out: previous accumulated
    filtered frame.
    """
    H, W = cfg.image_height, cfg.image_width
    f32 = jnp.float32

    pfx, pfy = prev_pixels[0], prev_pixels[1]
    ix = floor_int(pfx)
    iy = floor_int(pfy)
    fx = pfx - ix.astype(f32)
    fy = pfy - iy.astype(f32)
    tap_w = bilinear_weights(fx, fy)

    if taps is None:
        from .warp import gather_taps

        taps = gather_taps(prev_out, iy, ix, mode=cfg.warp_mode)
    prev_color = jnp.zeros((3, H, W), f32)
    total_weight = jnp.zeros((H, W), f32)
    for i, (dx, dy) in enumerate(TAP_OFFSETS):
        # The accept bits were only set for in-bounds taps in K1
        # (opencl/bmfr.cl:380-381), so no extra bounds test is
        # needed — mirroring the reference, which indexes unchecked
        # here (opencl/bmfr.cl:801-832). Indices are clipped for
        # memory safety.
        ok = (accept & jnp.uint8(1 << i)) > 0
        wgt = jnp.where(ok, tap_w[i], 0.0)
        prev_color = prev_color + wgt[None] * taps[i]
        total_weight = total_weight + wgt

    enabled = (frame > 0) & (not cfg.skip_second_accum)
    has_prev = enabled & (total_weight > 0.0)
    safe_tw = jnp.where(total_weight > 0.0, total_weight, 1.0)
    prev_color = prev_color / safe_tw[None]

    # blend_alpha = max(1/spp, SECOND_BLEND_ALPHA) (opencl/bmfr.cl:836-839)
    blend_alpha = jnp.where(
        has_prev,
        jnp.maximum(1.0 / spp.astype(f32), f32(cfg.second_blend_alpha)),
        f32(1.0),
    )
    prev_color = jnp.where(has_prev, prev_color, 0.0)

    accumulated = blend_alpha[None] * filtered + (1.0 - blend_alpha)[None] * prev_color

    # Albedo remodulation + gamma 1/2.2 + clamp (opencl/bmfr.cl:852-856)
    tone = jnp.clip(
        jnp.power(jnp.maximum(0.0, albedo * accumulated), f32(0.454545)),
        0.0, 1.0)
    return accumulated, tone
