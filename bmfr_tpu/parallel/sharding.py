"""Multi-chip scale-out: data parallelism over scenes.

The reference is strictly single-device (one in-order OpenCL queue,
opencl/bmfr.cpp:191); its only parallelism beyond the GPU grid is a host-side
OpenMP loop over frames for file IO (opencl/bmfr.cpp:259). The scale-out
axis, per SURVEY.md §2.4, is *data parallelism over scenes*: the 7-scene
dataset (README.md:10-12) denoised concurrently on several GPUs, one scene
(or scene-shard) per device. The temporal recurrence is inherently
frame-serial, so frames stay on-chip; no collectives are needed inside the
algorithm — at most an all-gather of metrics at the end, which XLA inserts
automatically when the result is read.

Implementation: ``shard_map`` over a 1-D ``Mesh`` with the scene batch axis
sharded. Each device runs the identical ``lax.scan`` frame chain on its
scenes. There is no TP/PP/EP/CP: the reference has no tensors to shard, no
sequence dimension, no experts — inventing them would be worse than useless
(SURVEY.md §2.4).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..pipeline.denoise import FrameInputs, denoise_sequence


def make_scene_mesh(devices=None, axis_name="scenes"):
    """1-D device mesh for scene-parallel denoising."""
    devices = devices if devices is not None else jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (axis_name,))


def denoise_scenes_sharded(cfg, mesh, inputs: FrameInputs, camera_matrices,
                           pixel_offsets, axis_name="scenes"):
    """Denoise a batch of scenes, sharded over the mesh.

    inputs: FrameInputs with leading axes ``[S, T, 3, H, W]`` (S scenes,
    T frames); camera_matrices ``[S, T, 4, 4]``; pixel_offsets ``[S, T, 2]``.
    S must be divisible by the mesh size. Returns ``[S, T, 3, H, W]``
    denoised results, sharded over scenes.
    """
    spec_in = (
        FrameInputs(P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        P(axis_name),
        P(axis_name),
    )

    def per_shard(shard_inputs, cams, offs):
        # vmap over the local scenes of this device; scan inside over
        # frames.
        def one_scene(sc_inputs, sc_cams, sc_offs):
            return denoise_sequence(cfg, sc_inputs, sc_cams, sc_offs)

        return jax.vmap(one_scene)(shard_inputs, cams, offs)

    # check_vma=False: pallas_call out_shapes carry no varying-mesh-axes
    # annotation; correctness of the sharded result is asserted
    # numerically against the unsharded computation in
    # tests/test_sharding.py and chip_smoke.py --four-cards.
    fn = jax.jit(jax.shard_map(
        per_shard, mesh=mesh, in_specs=spec_in, out_specs=P(axis_name),
        check_vma=False))
    return fn(inputs, camera_matrices, pixel_offsets)
