"""Jittered 32x32 block layout <-> image planes.

The reference scatters per-pixel feature vectors into a block-interleaved
``tmp_data`` buffer with mirrored, per-frame-jittered addressing
(opencl/bmfr.cl:314-316 and :455-476; the IN_ACCESS layout at :89-97), and
the reconstruction inverts the jitter per pixel (opencl/bmfr.cl:718-722).

Here both directions are pure data movement with static shapes:

* mirror = one symmetric pad (``mirror`` at opencl/bmfr.cl:209-222 is numpy's
  "symmetric" mode);
* jitter = one dynamic slice of the padded planes (the per-frame offset only
  moves the slice start);
* block layout = reshape + transpose.

No gather/scatter is involved.
"""

from __future__ import annotations

import jax.lax as lax
import jax.numpy as jnp

from ..features import evaluate_features
from ..geometry import BLOCK_OFFSETS

# Extremes of the BLOCK_OFFSETS table (opencl/bmfr.cl:267-285).
_MIN_OFF = -16
_MAX_OFF = 14


def _scaled_offsets(block_edge):
    """The jitter table, scaled for non-default block sizes.

    The reference supports only 32x32 blocks (opencl/bmfr.cpp:103); its
    +-16 offset table exactly fits the one-block margin. For the block-size
    sweep (BASELINE config 4) we scale the offsets proportionally so the
    jitter keeps covering the block extent without escaping the margin.
    """
    if block_edge == 32:
        return BLOCK_OFFSETS
    return (BLOCK_OFFSETS * block_edge) // 32


def _min_max_off(block_edge):
    if block_edge == 32:
        return _MIN_OFF, _MAX_OFF
    o = _scaled_offsets(block_edge)
    return int(o.min()), int(o.max())


def _pads(cfg):
    """Exact symmetric pad widths so every jittered margins-grid coordinate
    lands inside the padded plane."""
    half = cfg.block_edge // 2
    min_off, max_off = _min_max_off(cfg.block_edge)
    pad_lo = half - min_off  # 32 at defaults
    pad_hi_x = cfg.workset_with_margins_width - cfg.image_width - half + max_off
    pad_hi_y = cfg.workset_with_margins_height - cfg.image_height - half + max_off
    return pad_lo, max(pad_hi_x, 0), max(pad_hi_y, 0)


def jitter_offset(frame, block_edge=32):
    """Block jitter (ox, oy) for a traced frame number
    (opencl/bmfr.cl:315)."""
    table = jnp.asarray(_scaled_offsets(block_edge))
    return table[jnp.mod(frame, table.shape[0])]


def blockify_padded(cfg, planes):
    """Mirror pad ONLY — no jitter slice. The fused fitter
    (:mod:`bmfr_tpu.ops.fitter_fused`) reads each block straight from
    these planes at :func:`jitter_origin` plus the block's offset, so the
    jittered view is never copied."""
    pad_lo, pad_hi_x, pad_hi_y = _pads(cfg)
    return jnp.pad(
        planes, ((0, 0), (pad_lo, pad_hi_y), (pad_lo, pad_hi_x)),
        mode="symmetric")


def jitter_origin(cfg, frame):
    """The (row, col) origin of the jittered view inside
    :func:`blockify_padded`'s output — i32[2], traced;
    :func:`blockify_view` is exactly ``dynamic_slice(padded, origin)``."""
    pad_lo, _, _ = _pads(cfg)
    half = cfg.block_edge // 2
    off = jitter_offset(frame, cfg.block_edge)
    return jnp.stack([pad_lo - half + off[1],
                      pad_lo - half + off[0]]).astype(jnp.int32)


def blockify_view(cfg, planes, frame):
    """The jittered margins-grid view only — ``[C, H, W]`` planes ->
    ``[C, mh, mw]`` (mirror pad + per-frame jitter slice), without the
    block-layout transpose."""
    C = planes.shape[0]
    mw, mh = cfg.workset_with_margins_width, cfg.workset_with_margins_height
    origin = jitter_origin(cfg, frame)
    return lax.dynamic_slice(
        blockify_padded(cfg, planes), (jnp.int32(0), origin[0], origin[1]),
        (C, mh, mw))


def blockify_planes(cfg, planes, frame):
    """``[C, H, W]`` planes -> ``[n_blocks, C, block_pixels]`` jittered blocks.

    Margins-grid cell ``g`` reads image pixel ``mirror(g - half + offset)``
    (opencl/bmfr.cl:314-316); block ``b = gy//be * blocks_x + gx//be``,
    element ``e = gx%be + (gy%be)*be`` (opencl/bmfr.cl:455-464).
    """
    C = planes.shape[0]
    be = cfg.block_edge
    view = blockify_view(cfg, planes, frame)
    blocks = view.reshape(C, cfg.blocks_y, be, cfg.blocks_x, be)
    blocks = blocks.transpose(1, 3, 0, 2, 4)  # [by, bx, C, be, be]
    return blocks.reshape(cfg.n_blocks, C, cfg.block_pixels)


def unblockify_planes(cfg, blocks, frame, C):
    """Inverse of :func:`blockify_planes`, restricted to the image window.

    ``[n_blocks, C, block_pixels]`` -> ``[C, H, W]``, where image pixel ``p``
    reads margins-grid cell ``p + half - offset`` — the per-pixel inverse
    jitter of the reconstruction (opencl/bmfr.cl:718-722).
    """
    be = cfg.block_edge
    half = be // 2
    mw, mh = cfg.workset_with_margins_width, cfg.workset_with_margins_height
    view = blocks.reshape(cfg.blocks_y, cfg.blocks_x, C, be, be)
    view = view.transpose(2, 0, 3, 1, 4).reshape(C, mh, mw)
    off = jitter_offset(frame, cfg.block_edge)
    start_x = half - off[0]
    start_y = half - off[1]
    return lax.dynamic_slice(
        view, (jnp.int32(0), jnp.int32(start_y), jnp.int32(start_x)),
        (C, cfg.image_height, cfg.image_width))


def build_feature_blocks(cfg, normals, positions, accum_color, frame):
    """Feature-vector build + block store of K1 (opencl/bmfr.cl:447-476).

    Evaluates the configured feature basis plus the three accumulated color
    channels, sanitizes NaNs to zero, applies the reduced-precision storage
    contract (clamp to +-65504 for fp16, opencl/bmfr.cl:471-473), and lays
    the result out as ``[n_blocks, buffer_count, block_pixels]``.
    """
    feats = evaluate_features(cfg.all_features, normals, positions)
    planes = jnp.concatenate([feats, accum_color], axis=0)
    planes = jnp.where(jnp.isnan(planes), 0.0, planes)
    if cfg.tmp_data_dtype == "float16":
        planes = jnp.clip(planes, -65504.0, 65504.0)
    blocks = blockify_planes(cfg, planes, frame)
    if cfg.tmp_data_dtype != "float32":
        blocks = blocks.astype(cfg.tmp_data_dtype)
    return blocks
