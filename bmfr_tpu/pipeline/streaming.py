"""Streaming multi-scene pipeline: EXR ingest overlapped with compute.

BASELINE config 5: denoise many scenes concurrently with host IO running
ahead of the device. The reference preloads all 60 frames before the first
kernel launch (opencl/bmfr.cpp:252-313); here frame *chunks* are loaded by
a background thread (the native pthread loader when built) and uploaded
with ``jax.device_put`` while the device scans the previous chunk — the
temporal recurrence carries across chunks through the ``TemporalState``.

Single-scene streaming runs on one device; multiple scenes stream
concurrently with one worker per scene/device (scene data parallelism).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from .denoise import FrameInputs, denoise_frame
from .state import TemporalState


def _to_tchw(arr):
    return np.ascontiguousarray(np.moveaxis(arr, -1, 1)).astype(np.float32)


def _chunk_ranges(total, chunk):
    return [(s, min(s + chunk, total)) for s in range(0, total, chunk)]


def make_chunk_runner(cfg):
    """One jitted chunk scanner, reused across chunks and scenes.

    Signature: (state, inputs[T,...], cams_ext[T+? ,4,4], offs[T,2], t0)
    where ``cams_ext[i]`` is the view-projection matrix of frame
    ``t0+i-1`` (the reference's one-frame matrix lag,
    opencl/bmfr.cpp:440-444).
    """

    @jax.jit
    def run_chunk(state, inputs, cams_ext, offs, t0):
        def body(state, i):
            frame_in = FrameInputs(
                inputs.normals[i], inputs.positions[i],
                inputs.noisy[i], inputs.albedo[i])
            new_state, outputs = denoise_frame(
                cfg, state, frame_in, cams_ext[i], offs[i], t0 + i)
            return new_state, outputs["result"]

        n = inputs.noisy.shape[0]
        return jax.lax.scan(body, state, jnp.arange(n, dtype=jnp.int32))

    return run_chunk


def stream_scene(cfg, scene=None, chunk_frames=10, device=None, loader=None,
                 frame_count=None, runner=None):
    """Denoise one scene with chunked, overlapped ingest.

    Either pass a SceneDescriptor (``scene``) or a ``loader(frames) ->
    dict`` with the standard keys (normals/positions/noisy/albedo HWC,
    camera_matrices, pixel_offsets) plus ``frame_count``. Returns
    ``np.ndarray [T, 3, H, W]`` of TAA results.
    """
    device = device or jax.devices()[0]
    load = loader or (lambda fr: scene.load_frames(frames=fr))
    T = frame_count if frame_count is not None else scene.frame_count
    ranges = _chunk_ranges(T, chunk_frames)
    run_chunk = runner or make_chunk_runner(cfg)

    def fetch(rng):
        s, e = rng
        data = load(list(range(s, e)))
        inputs = FrameInputs(
            normals=jax.device_put(_to_tchw(data["normals"]), device),
            positions=jax.device_put(_to_tchw(data["positions"]), device),
            noisy=jax.device_put(_to_tchw(data["noisy"]), device),
            albedo=jax.device_put(_to_tchw(data["albedo"]), device),
        )
        return (inputs, np.asarray(data["camera_matrices"], np.float32),
                jax.device_put(
                    np.asarray(data["pixel_offsets"], np.float32), device))

    state = TemporalState.initial(cfg)
    results = []
    last_cam = None
    # (a short final chunk triggers one extra compile of run_chunk)
    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = ex.submit(fetch, ranges[0])
        for idx, (s, e) in enumerate(ranges):
            inputs, cams, offs = pending.result()
            if idx + 1 < len(ranges):
                pending = ex.submit(fetch, ranges[idx + 1])

            # cams_ext[i] = matrix of frame s+i-1 (lag);
            # chunk 0 starts with matrix 0 (opencl/bmfr.cpp:440)
            prev = cams[0:1] if last_cam is None else last_cam[None]
            cams_ext = np.concatenate([prev, cams[:-1]], axis=0)
            last_cam = cams[-1]

            state, res = run_chunk(
                state, inputs, jax.device_put(cams_ext, device), offs,
                jnp.int32(s))
            results.append(np.asarray(res))
    return np.concatenate(results, axis=0)


def stream_scenes(cfg, scenes, chunk_frames=10, devices=None,
                  per_scene_limits=True):
    """Stream several scenes concurrently, one device per scene
    (round-robin when scenes outnumber devices). Returns a list of
    per-scene result arrays.

    Each scene is denoised with its *own* geometry and reprojection discard
    thresholds from its ``camera_matrices.h`` — the reference bakes these
    per scene at compile time (opencl/bmfr.cpp:226-227), so applying the
    first scene's limits everywhere would silently mis-denoise the rest.
    Scenes with identical configs share one compiled runner.
    """
    devices = devices or jax.devices()

    def scene_cfg(sd):
        c = cfg
        if getattr(sd, "width", None) and getattr(sd, "height", None):
            c = c.replace(image_width=sd.width, image_height=sd.height)
        if per_scene_limits and hasattr(sd, "load_camera"):
            cam = sd.load_camera()
            if "position_limit_squared" in cam:
                c = c.replace(
                    position_limit_squared=cam["position_limit_squared"],
                    normal_limit_squared=cam["normal_limit_squared"])
        return c.validate()

    cfgs = [scene_cfg(sd) for sd in scenes]
    runners = {}
    for c in cfgs:
        if c not in runners:
            runners[c] = make_chunk_runner(c)

    def work(i):
        return stream_scene(
            cfgs[i], scenes[i], chunk_frames=chunk_frames,
            device=devices[i % len(devices)], runner=runners[cfgs[i]])

    with ThreadPoolExecutor(max_workers=len(scenes)) as ex:
        return list(ex.map(work, range(len(scenes))))
