"""Stage K1 — temporal reprojection + first accumulation of noisy color.

Redesign of ``accumulate_noisy_data`` (opencl/bmfr.cl:290-485). The
reference runs one work-item per *margins-grid* cell (1312x768), each
mirroring its coordinate into the image and redundantly recomputing the
accumulation for duplicated border pixels; outputs are stored only by the
unique in-image writer (opencl/bmfr.cl:478-484). Because the computation is a
pure function of the (mirrored) pixel, that is equivalent to computing every
image pixel exactly once — which is what we do here, on dense ``[H, W]``
arrays with masked bilinear gathers instead of branches. The block-layout
store (opencl/bmfr.cl:455-476) is factored out into
:mod:`bmfr_tpu.ops.blockify`.
"""

from __future__ import annotations

import jax.numpy as jnp

from .gather import TAP_OFFSETS, bilinear_weights, floor_int, in_bounds


def reproject_coords(cfg, positions, prev_cam, pixel_offset):
    """Reprojected previous-frame coordinates for every pixel
    (opencl/bmfr.cl:338-356). Returns (pfx, pfy) f32 [H, W]."""
    H, W = cfg.image_height, cfg.image_width
    wp = positions

    def cam_dot(col):
        return (prev_cam[0, col] * wp[0] + prev_cam[1, col] * wp[1]
                + prev_cam[2, col] * wp[2] + prev_cam[3, col])

    u = cam_dot(0)
    v = cam_dot(1)
    w = cam_dot(3)
    pfx = (u / w + 1.0) * 0.5 * W - pixel_offset[0]
    pfy = (v / w + 1.0) * 0.5 * H - (1.0 - pixel_offset[1])
    return pfx, pfy


def accumulate_noisy_data(cfg, normals, positions, noisy, prev_normals,
                          prev_positions, prev_noisy, prev_spp, prev_cam,
                          pixel_offset, frame, taps=None):
    """First temporal accumulation on the image grid.

    Args:
      normals/positions/noisy: current frame ``f32[3, H, W]``.
      prev_*: previous-frame recurrent buffers (``prev_spp`` is ``[H, W]``).
      prev_cam: ``f32[4, 4]`` view-projection matrix of the *previous* frame,
        stored row-major as in ``camera_matrices.h`` (the reprojection uses
        its columns, opencl/bmfr.cl:342-347).
      pixel_offset: ``f32[2]`` sub-pixel jitter of the current frame.
      frame: traced int32 frame number.

    Returns dict with ``accum f32[3,H,W]``, ``spp u8[H,W]``,
    ``prev_pixels f32[2,H,W]``, ``accept u8[H,W]``.

    ``taps``: optionally the precomputed ``[4, 10, H, W]`` bilinear taps of
    (prev_positions, prev_normals, prev_noisy, prev_spp) — supplied by the
    frame orchestrator, which fetches the taps of *all* temporal stages in
    one shared gather (see pipeline/denoise.py).
    """
    H, W = cfg.image_height, cfg.image_width
    f32 = jnp.float32
    wp = positions

    pfx, pfy = reproject_coords(cfg, positions, prev_cam, pixel_offset)

    ix = floor_int(pfx)
    iy = floor_int(pfy)

    fx = pfx - ix.astype(f32)
    fy = pfy - iy.astype(f32)
    tap_w = bilinear_weights(fx, fy)

    # --- masked bilinear taps (opencl/bmfr.cl:374-419) ---
    if taps is None:
        from .warp import gather_taps

        stacked = jnp.concatenate(
            [prev_positions, prev_normals, prev_noisy,
             prev_spp.astype(f32)[None]], axis=0)   # [10, H, W]
        taps = gather_taps(stacked, iy, ix, mode=cfg.warp_mode)

    prev_color = jnp.zeros((3, H, W), f32)
    sample_spp = jnp.zeros((H, W), f32)
    total_weight = jnp.zeros((H, W), f32)
    accept = jnp.zeros((H, W), jnp.uint8)

    pos_lim = f32(cfg.position_limit_squared)
    nrm_lim = f32(cfg.normal_limit_squared)

    for i, (dx, dy) in enumerate(TAP_OFFSETS):
        ok = in_bounds(iy + dy, ix + dx, H, W)
        pos_d = taps[i, 0:3] - wp
        ok &= (pos_d[0] * pos_d[0] + pos_d[1] * pos_d[1]
               + pos_d[2] * pos_d[2]) < pos_lim
        nrm_d = taps[i, 3:6] - normals
        ok &= (nrm_d[0] * nrm_d[0] + nrm_d[1] * nrm_d[1]
               + nrm_d[2] * nrm_d[2]) < nrm_lim

        wgt = jnp.where(ok, tap_w[i], 0.0)
        prev_color = prev_color + wgt[None] * taps[i, 6:9]
        sample_spp = sample_spp + wgt * taps[i, 9]
        total_weight = total_weight + wgt
        accept = accept | jnp.where(ok, jnp.uint8(1 << i),
                                    jnp.uint8(0))

    not_first = (frame > 0)
    has_prev = not_first & (total_weight > 0.0)
    safe_tw = jnp.where(total_weight > 0.0, total_weight, 1.0)
    prev_color = prev_color / safe_tw[None]
    sample_spp = sample_spp / safe_tw

    # blend_alpha = max(1/(spp+1), BLEND_ALPHA), 1 when no history
    # (opencl/bmfr.cl:421-429)
    blend_alpha = jnp.where(
        has_prev,
        jnp.maximum(1.0 / (sample_spp + 1.0), f32(cfg.blend_alpha)),
        f32(1.0),
    )

    # new spp, saturating uint8 round-half-even (opencl/bmfr.cl:432-442)
    rounded = jnp.clip(jnp.round(sample_spp), 0.0, 254.0).astype(jnp.int32) + 1
    capped = jnp.where(sample_spp > 254.0, 255, rounded)
    new_spp = jnp.where(has_prev, capped, 1).astype(jnp.uint8)

    accum = blend_alpha[None] * noisy + (1.0 - blend_alpha)[None] * prev_color

    # prev-pixel map: own coordinates when there is no previous frame
    # (opencl/bmfr.cl:324-325)
    own_x = jnp.broadcast_to(jnp.arange(W, dtype=f32)[None, :], (H, W))
    own_y = jnp.broadcast_to(jnp.arange(H, dtype=f32)[:, None], (H, W))
    prev_pixels = jnp.where(
        not_first, jnp.stack([pfx, pfy]), jnp.stack([own_x, own_y]))

    accept = jnp.where(not_first, accept, jnp.uint8(0))

    return dict(accum=accum, spp=new_spp, prev_pixels=prev_pixels,
                accept=accept)
