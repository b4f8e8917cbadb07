"""Stage K5 — temporal anti-aliasing with a YCoCg neighborhood clamp.

Redesign of ``taa`` (opencl/bmfr.cl:860-974). The 3x3 neighborhood
min/max (box and cross averaged) is computed with static shifts + edge
masks — pure elementwise work, no gathers; only the bilinear sample of the
previous TAA result needs gathers (4 masked taps).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..color import rgb_to_ycocg, ycocg_to_rgb
from .gather import bilinear_weights, floor_int


def _shifted(planes, dy, dx):
    """planes shifted so that out[:, y, x] = planes[:, y+dy, x+dx], with a
    validity mask for out-of-image sources."""
    C, H, W = planes.shape
    pad = jnp.pad(planes, ((0, 0), (1, 1), (1, 1)))
    view = pad[:, 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
    yv = jnp.arange(H)[:, None] + dy
    xv = jnp.arange(W)[None, :] + dx
    ok = (yv >= 0) & (yv < H) & (xv >= 0) & (xv < W)
    return view, ok


def taa(cfg, prev_pixels, new_frame, prev_result, frame, taps=None):
    """new_frame: tone-mapped K4 output ``f32[3,H,W]``; prev_result: the
    previous frame's TAA output. Returns ``f32[3,H,W]``."""
    H, W = cfg.image_height, cfg.image_width
    f32 = jnp.float32

    pfx, pfy = prev_pixels[0], prev_pixels[1]
    ix = floor_int(pfx)
    iy = floor_int(pfy)

    # --- 3x3 YCoCg AABB via shifts (opencl/bmfr.cl:893-920) ---
    # The neighborhood scan is the stage's bandwidth cost (9 shifted
    # min/max passes over the frame); with residual_dtype="bfloat16" it
    # runs at half the bytes, perturbing the clamp bounds by at most
    # one bf16 ulp (~0.4% relative).
    rd = (jnp.bfloat16 if cfg.residual_dtype == "bfloat16" else
          jnp.float32)
    ycc = rgb_to_ycocg(new_frame)
    yccr = ycc.astype(rd)
    inf = jnp.array(jnp.inf, rd)
    mn_box = jnp.full_like(yccr, inf)
    mx_box = jnp.full_like(yccr, -inf)
    mn_cross = jnp.full_like(yccr, inf)
    mx_cross = jnp.full_like(yccr, -inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            view, ok = _shifted(yccr, dy, dx)
            lo = jnp.where(ok[None], view, inf)
            hi = jnp.where(ok[None], view, -inf)
            mn_box = jnp.minimum(mn_box, lo)
            mx_box = jnp.maximum(mx_box, hi)
            if dx == 0 or dy == 0:
                mn_cross = jnp.minimum(mn_cross, lo)
                mx_cross = jnp.maximum(mx_cross, hi)
    mn_box, mx_box, mn_cross, mx_cross = (
        x.astype(f32) for x in (mn_box, mx_box, mn_cross, mx_cross))

    # --- bilinear sample of previous result (opencl/bmfr.cl:922-960) ---
    fx = pfx - ix.astype(f32)
    fy = pfy - iy.astype(f32)
    w00, w10, w01, w11 = bilinear_weights(fx, fy)
    x_lo_ok = ix >= 0
    x_hi_ok = ix < W - 1
    y_lo_ok = iy >= 0
    y_hi_ok = iy < H - 1

    if taps is None:
        from .warp import gather_taps

        taps = gather_taps(prev_result, iy, ix, mode=cfg.warp_mode)
    weighted = (
        (w00, y_lo_ok & x_lo_ok),
        (w10, y_lo_ok & x_hi_ok),
        (w01, y_hi_ok & x_lo_ok),
        (w11, y_hi_ok & x_hi_ok),
    )
    prev_color = jnp.zeros_like(new_frame)
    total_weight = jnp.zeros((H, W), f32)
    for i, (wgt, ok) in enumerate(weighted):
        wm = jnp.where(ok, wgt, 0.0)
        prev_color = prev_color + wm[None] * taps[i]
        total_weight = total_weight + wm

    safe_tw = jnp.where(total_weight > 0.0, total_weight, 1.0)
    prev_color = prev_color / safe_tw[None]

    clamped = jnp.clip(
        rgb_to_ycocg(prev_color),
        (mn_box + mn_cross) * 0.5,
        (mx_box + mx_cross) * 0.5,
    )
    prev_rgb = ycocg_to_rgb(clamped)

    blended = (f32(cfg.taa_blend_alpha) * new_frame
               + (1.0 - f32(cfg.taa_blend_alpha)) * prev_rgb)

    # Early-out: first frame or reprojection fully off-screen
    # (opencl/bmfr.cl:884-890)
    off_screen = (ix < -1) | (iy < -1) | (ix >= W) | (iy >= H)
    passthrough = off_screen | (frame == 0) | cfg.skip_taa
    return jnp.where(passthrough[None], new_frame, blended)
