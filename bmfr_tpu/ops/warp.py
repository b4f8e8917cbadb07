"""Bilinear tap engine: gather strategies for the temporal stages.

The reference reads its four bilinear taps in place per pixel
(opencl/bmfr.cl:374-419, :801-832, :929-960). Here the taps of all 16
recurrent channels are fetched with XLA gathers, in one of three modes:

  * ``float32``: one gather op per tap (4 total; bit-exact — the default,
    used by the oracle-equivalence tests and fidelity work).
  * ``packed_bf16``: two bf16 *channels* per 32-bit word (4 ops, half the
    bytes).
  * ``packed_x_bf16``: two bf16 horizontal *taps* per 32-bit word — the
    whole four-tap fetch of up to 16 channels in 2 gather ops, at half
    the bytes (~0.4% relative rounding on gathered history).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .gather import TAP_OFFSETS, gather_planes


def pack_pairs_bf16(planes):
    """[C, H, W] f32 -> [ceil(C/2), H, W] i32, two bf16 per lane."""
    C = planes.shape[0]
    if C % 2:
        planes = jnp.concatenate([planes, jnp.zeros_like(planes[:1])], 0)
    lo = planes[0::2].astype(jnp.bfloat16)
    hi = planes[1::2].astype(jnp.bfloat16)
    lo_b = jax.lax.bitcast_convert_type(lo, jnp.uint16).astype(jnp.uint32)
    hi_b = jax.lax.bitcast_convert_type(hi, jnp.uint16).astype(jnp.uint32)
    return (lo_b | (hi_b << 16)).astype(jnp.int32)


def unpack_pairs_bf16(packed, C):
    """i32 [P, ...] -> f32 [2P(, trimmed to C), ...]."""
    u = packed.astype(jnp.uint32)
    lo = jax.lax.bitcast_convert_type(
        (u & jnp.uint32(0xFFFF)).astype(jnp.uint16), jnp.bfloat16)
    hi = jax.lax.bitcast_convert_type(
        (u >> 16).astype(jnp.uint16), jnp.bfloat16)
    out = jnp.stack([lo, hi], axis=1).reshape(
        (-1,) + packed.shape[1:])
    return out[:C].astype(jnp.float32)


def pack_x_pairs_bf16(planes):
    """[C, H, W] f32 -> [C, H, W] i32 where lane (y, x) holds
    (bf16(S[y,x]), bf16(S[y,x+1])) — one gather fetches both horizontal
    bilinear taps."""
    shifted = jnp.concatenate(
        [planes[:, :, 1:], planes[:, :, -1:]], axis=2)
    lo = planes.astype(jnp.bfloat16)
    hi = shifted.astype(jnp.bfloat16)
    lo_b = jax.lax.bitcast_convert_type(lo, jnp.uint16).astype(jnp.uint32)
    hi_b = jax.lax.bitcast_convert_type(hi, jnp.uint16).astype(jnp.uint32)
    return (lo_b | (hi_b << 16)).astype(jnp.int32)


def gather_taps(planes, iy, ix, mode="float32"):
    """All four bilinear taps of ``planes`` at integer coords (iy, ix).

    planes: f32 ``[C, H, W]``; iy/ix: i32 ``[H, W]`` (floor of the
    reprojected position). Returns f32 ``[4, C, H, W]`` in reference tap
    order ((0,0),(1,0),(0,1),(1,1) — opencl/bmfr.cl:359-363). Indices are
    clipped; validity must be masked by the caller.

    Mode ``packed_x_bf16`` fetches each tap row's horizontal pair in one
    32-bit gather — 2 gather ops total for all four taps of all channels.
    """
    C = planes.shape[0]
    if mode == "packed_x_bf16":
        src = pack_x_pairs_bf16(planes)                # [C, H, W] i32
        row0 = gather_planes(src, iy, ix).astype(jnp.uint32)
        row1 = gather_planes(src, iy + 1, ix).astype(jnp.uint32)

        def lo(u):
            return jax.lax.bitcast_convert_type(
                (u & jnp.uint32(0xFFFF)).astype(jnp.uint16),
                jnp.bfloat16).astype(jnp.float32)

        def hi(u):
            return jax.lax.bitcast_convert_type(
                (u >> 16).astype(jnp.uint16),
                jnp.bfloat16).astype(jnp.float32)

        # Clipping notes: at x == W-1 the packed pair duplicates the edge
        # value, but tap (1, dy) there is out of bounds and masked by the
        # caller. At ix < 0 the gather clips to x=0, whose *lo* half is
        # the in-bounds dx=1 tap (x=0) — select accordingly.
        neg = (ix < 0)[None]
        tap10 = jnp.where(neg, lo(row0), hi(row0))
        tap11 = jnp.where(neg, lo(row1), hi(row1))
        return jnp.stack([lo(row0), tap10, lo(row1), tap11])
    if mode == "packed_bf16":
        src = pack_pairs_bf16(planes)
        taps = []
        for dx, dy in TAP_OFFSETS:
            got = gather_planes(src, iy + dy, ix + dx)
            taps.append(unpack_pairs_bf16(got, C))
        return jnp.stack(taps)
    taps = [gather_planes(planes, iy + dy, ix + dx)
            for dx, dy in TAP_OFFSETS]
    return jnp.stack(taps)
