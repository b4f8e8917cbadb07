"""The per-frame denoise step and the frame-sequence scan.

This is the equivalent of the reference's per-frame 5-kernel chain
(opencl/bmfr.cpp:417-485): one pure jitted function
``state, inputs -> state, outputs`` per frame, and a ``jax.lax.scan`` over a
stacked 60-frame animation for throughput runs. The public per-frame API
mirrors the real-use contract described at opencl/bmfr.cpp:415-416 (feature
buffers + camera matrix in, denoised frame out).

The reference's one-frame matrix lag — frame N is reprojected with
``camera_matrices[N-1]`` but jittered with ``pixel_offsets[N]``
(opencl/bmfr.cpp:440-444) — is reproduced in :func:`denoise_sequence`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.accumulate import accumulate_filtered_data
from ..ops.blockify import build_feature_blocks
from ..ops.fitter import fit_blocks
from ..ops.reproject import accumulate_noisy_data
from ..ops.taa import taa
from ..ops.weighted_sum import weighted_sum
from .state import TemporalState


class FrameInputs(NamedTuple):
    """One frame of path-tracer outputs (the four EXR buffers,
    opencl/bmfr.cpp:49-52), channels-first f32[3, H, W] each."""

    normals: jnp.ndarray
    positions: jnp.ndarray
    noisy: jnp.ndarray
    albedo: jnp.ndarray


def denoise_frame(cfg, state, inputs: FrameInputs,
                  prev_cam, pixel_offset, frame, history="dynamic"):
    """Run the full 5-stage chain for one frame.

    ``history`` statically pins the history branch: ``"dynamic"`` gates
    on ``frame > 0`` under ``lax.cond`` (the general per-frame API),
    ``"never"``/``"always"`` compile only the corresponding branch (the
    sequence scan hoists frame 0 out, so its steady-state body carries no
    conditional and none of the cond's buffer copies).

    Returns ``(new_state, outputs)`` where outputs is a dict holding the
    final ``result`` plus the intermediates needed for testing/debugging.

    The three temporal stages sample the *same* reprojected coordinates
    (K4/K5 reuse the prev-pixel map K1 stores, opencl/bmfr.cpp:376,382),
    so all 16 recurrent channels (positions 3, normals 3, noisy 3, spp 1,
    out 3, result 3) are fetched in one stacked gather per bilinear tap
    here, and the per-stage tap values are passed down.
    """
    from ..ops.gather import floor_int
    from ..ops.reproject import reproject_coords
    from ..ops.warp import gather_taps

    # named scopes flow into the compiled op names so xplane traces can
    # attribute device time per stage (bmfr_tpu/xplane.py; the analogue
    # of the reference's per-kernel CL event timers, bmfr.cpp:386-412)
    H, W = cfg.image_height, cfg.image_width
    assert history in ("dynamic", "never", "always"), history

    def gate(fetch, no_history):
        if history == "always":
            return fetch(None)
        if history == "never":
            return no_history(None)
        return jax.lax.cond(frame > 0, fetch, no_history, None)

    with jax.named_scope("warp_taps"):
        pfx, pfy = reproject_coords(
            cfg, inputs.positions, prev_cam, pixel_offset)
        ix = floor_int(pfx)
        iy = floor_int(pfy)

        def fetch(_):
            stacked = jnp.concatenate(
                [state.positions, state.normals, state.noisy,
                 state.spp.astype(jnp.float32)[None], state.out,
                 state.result], axis=0)                # [16, H, W]
            return gather_taps(stacked, iy, ix, mode=cfg.warp_mode)

        def no_history(_):
            # At frame 0 every consumer masks its taps out. Derived from
            # state so both branches carry the same device-variance under
            # shard_map.
            return state.result[0][None, None] * 0.0 + jnp.zeros(
                (4, 16, H, W), jnp.float32)

        all_taps = gate(fetch, no_history)
        taps_k1 = all_taps[:, 0:10]
        taps_k4 = all_taps[:, 10:13]
        taps_k5 = all_taps[:, 13:16]

    with jax.named_scope("k1_accumulate_noisy"):
        k1 = accumulate_noisy_data(
            cfg, inputs.normals, inputs.positions, inputs.noisy,
            state.normals, state.positions, state.noisy, state.spp,
            prev_cam, pixel_offset, frame, taps=taps_k1)

    weights = mins_maxs = None   # not materialized by the fused fitter
    if cfg.skip_fitting:
        filtered = k1["accum"]
    elif cfg.fitter_impl == "fused":
        from ..ops.fitter_fused import filtered_fused

        filtered = filtered_fused(cfg, inputs.normals, inputs.positions,
                                  k1["accum"], frame)
    else:
        with jax.named_scope("k2_blockify"):
            tmp = build_feature_blocks(
                cfg, inputs.normals, inputs.positions, k1["accum"], frame)
        with jax.named_scope("k2_fitter"):
            weights, mins_maxs = fit_blocks(cfg, tmp, frame)

        with jax.named_scope("k3_weighted_sum"):
            filtered = weighted_sum(
                cfg, weights, mins_maxs, inputs.normals, inputs.positions,
                k1["accum"], frame, feature_blocks=tmp)

    with jax.named_scope("k4_accumulate_filtered"):
        out, tone = accumulate_filtered_data(
            cfg, filtered, k1["prev_pixels"], k1["accept"], inputs.albedo,
            k1["spp"], state.out, frame, taps=taps_k4)

    with jax.named_scope("k5_taa"):
        result = taa(cfg, k1["prev_pixels"], tone, state.result, frame,
                     taps=taps_k5)

    new_state = TemporalState(
        normals=inputs.normals,
        positions=inputs.positions,
        noisy=k1["accum"],
        spp=k1["spp"],
        out=out,
        result=result,
    )
    outputs = dict(
        result=result, tone=tone, out=out, filtered=filtered,
        accum=k1["accum"], spp=k1["spp"], prev_pixels=k1["prev_pixels"],
        accept=k1["accept"], weights=weights, mins_maxs=mins_maxs,
    )
    return new_state, outputs


def make_denoise_frame(cfg, donate=True):
    """A jit-compiled per-frame step with ``cfg`` closed over statically.

    With ``donate=True`` the temporal state buffers are donated, so the
    recurrence updates in place on device — the functional equivalent of the
    reference's double-buffer swap (opencl/bmfr.cpp:482-484) with the same
    memory footprint.
    """

    @functools.partial(
        jax.jit, donate_argnums=(0,) if donate else ())
    def step(state, inputs, prev_cam, pixel_offset, frame):
        new_state, outputs = denoise_frame(
            cfg, state, inputs, prev_cam, pixel_offset, frame)
        return new_state, outputs["result"]

    return step


def denoise_sequence(cfg, inputs: FrameInputs, camera_matrices,
                     pixel_offsets, lite_outputs=True, initial_state=None):
    """Denoise a stacked animation with ``lax.scan``.

    inputs: FrameInputs with a leading time axis ``[T, 3, H, W]``;
    camera_matrices ``f32[T, 4, 4]``; pixel_offsets ``f32[T, 2]``.
    Returns the stacked TAA results ``f32[T, 3, H, W]`` (plus tone-mapped
    frames when ``lite_outputs`` is False).
    """
    if initial_state is None:
        # Derive from the inputs (not fresh constants) so device-varying
        # axes propagate correctly under shard_map (see parallel/sharding).
        z3 = jnp.zeros_like(inputs.noisy[0])
        state = TemporalState(
            normals=z3, positions=z3, noisy=z3,
            spp=jnp.zeros_like(inputs.noisy[0, 0], dtype=jnp.uint8),
            out=z3, result=z3)
    else:
        state = initial_state
    T = inputs.noisy.shape[0]

    def step(state, t, history):
        prev_cam = camera_matrices[jnp.maximum(t - 1, 0)]
        frame_in = FrameInputs(
            normals=inputs.normals[t],
            positions=inputs.positions[t],
            noisy=inputs.noisy[t],
            albedo=inputs.albedo[t],
        )
        new_state, outputs = denoise_frame(
            cfg, state, frame_in, prev_cam, pixel_offsets[t], t,
            history=history)
        if lite_outputs:
            return new_state, outputs["result"]
        return new_state, (outputs["result"], outputs["tone"])

    # Frame 0 statically has no history: hoisting it out of the scan
    # removes the ``frame > 0`` conditional (and its buffer copies)
    # from the steady-state body entirely.
    state, ys0 = step(state, jnp.int32(0), "never")
    _, rest = jax.lax.scan(
        lambda s, t: step(s, t, "always"), state,
        jnp.arange(1, T, dtype=jnp.int32), unroll=1)
    return jax.tree.map(
        lambda a, b: jnp.concatenate([a[None], b], axis=0), ys0, rest)
