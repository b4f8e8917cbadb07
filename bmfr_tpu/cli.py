"""Command-line runner: the ``main``/``tasks`` equivalent.

The reference's entry point takes no arguments — everything is compile-time
(opencl/bmfr.cpp:558). Here the same workflow (load scene -> run 60-frame
chain -> profile -> write PNGs) is a CLI with runtime flags:

    python -m bmfr_tpu.cli --scene /data/classroom --output outputs/
    python -m bmfr_tpu.cli --synthetic --frames 60 --width 1280 --height 720

Prints the per-stage profiling report in the reference's
mean/min/max/total format (opencl/bmfr.cpp:489-517).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .config import BMFRConfig
from .metrics import psnr


def _build_argparser():
    p = argparse.ArgumentParser(description="BMFR denoiser")
    p.add_argument("--scene", help="scene directory (TUNI layout)")
    p.add_argument("--synthetic", action="store_true",
                   help="run on the built-in synthetic scene")
    p.add_argument("--synthetic-scene", default="orbit",
                   choices=["orbit", "corridor"],
                   help="synthetic scene type (orbit: lateral flow; "
                        "corridor: forward-dolly disocclusion)")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--output", default="outputs",
                   help="output directory for PNGs")
    p.add_argument("--no-output", action="store_true")
    p.add_argument("--solver", default="householder",
                   choices=["householder", "cholesky"])
    p.add_argument("--fitter-impl", default="xla", choices=["xla", "fused"])
    p.add_argument("--tmp-dtype", default="float32",
                   choices=["float32", "float16", "bfloat16"])
    p.add_argument("--warp-mode", default="float32",
                   choices=["float32", "packed_bf16", "packed_x_bf16"])
    p.add_argument("--residual-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--block-edge", type=int, default=32)
    p.add_argument("--mode", default="frame",
                   choices=["frame", "scan", "stream"],
                   help="per-frame jitted steps, one lax.scan, or chunked "
                        "streaming with overlapped ingest")
    p.add_argument("--chunk-frames", type=int, default=10,
                   help="frames per streaming chunk")
    p.add_argument("--scenes-root",
                   help="denoise every scene under this directory "
                        "concurrently (TUNI layout, streaming mode)")
    p.add_argument("--device", type=int, default=0,
                   help="device index (the reference's PLATFORM_INDEX/"
                        "DEVICE_INDEX, bmfr.cpp:33-34)")
    p.add_argument("--skip-fitting", action="store_true")
    p.add_argument("--skip-second-accum", action="store_true")
    p.add_argument("--skip-taa", action="store_true")
    return p


def load_inputs(args):
    if args.scene:
        from .io.dataset import probe_scene

        sd = probe_scene(args.scene)  # auto-detect geometry + frame count
        args.width, args.height = sd.width, sd.height
        sd.frame_count = min(sd.frame_count, args.frames)
        data = sd.load_frames()
        limits = dict(
            position_limit_squared=data["position_limit_squared"],
            normal_limit_squared=data["normal_limit_squared"])
    else:
        from .io.fixtures import synthetic_sequence

        data = synthetic_sequence(
            width=args.width, height=args.height, frames=args.frames,
            scene=args.synthetic_scene)
        limits = dict(position_limit_squared=0.03, normal_limit_squared=0.5)
    return data, limits


def _write_outputs_parallel(outdir, named_frames, threads=None):
    """Parallel PNG writes (the reference uses an OpenMP parallel-for,
    opencl/bmfr.cpp:521-547)."""
    from concurrent.futures import ThreadPoolExecutor

    from .io.exr import write_png

    os.makedirs(outdir, exist_ok=True)

    def write_one(item):
        name, chw = item
        write_png(os.path.join(outdir, name), np.moveaxis(chw, 0, -1))

    with ThreadPoolExecutor(max_workers=threads or (os.cpu_count() or 8)) as ex:
        list(ex.map(write_one, named_frames))
    print(f"Wrote {len(named_frames)} PNGs to {outdir}/")


def main(argv=None):
    args = _build_argparser().parse_args(argv)
    import jax
    import jax.numpy as jnp

    from . import FrameInputs, TemporalState, make_denoise_frame
    from .profiling import ProfilingInfo, print_report, timed

    print("Initialize.")
    devices = jax.devices()
    if args.device >= len(devices):
        print(f"Device index {args.device} out of range "
              f"({len(devices)} available)")
        return 1
    device = devices[args.device]
    jax.config.update("jax_default_device", device)
    print(f"Using device: {device}")

    def make_cfg(limits):
        return BMFRConfig(
            image_width=args.width, image_height=args.height,
            solver=args.solver, fitter_impl=args.fitter_impl,
            tmp_data_dtype=args.tmp_dtype, block_edge=args.block_edge,
            warp_mode=args.warp_mode,
            residual_dtype=args.residual_dtype,
            skip_fitting=args.skip_fitting,
            skip_second_accum=args.skip_second_accum,
            skip_taa=args.skip_taa, **limits).validate()

    if not args.scenes_root:
        print("Loading input data.")
        t0 = time.perf_counter()
        data, limits = load_inputs(args)
        print(f"  loaded in {time.perf_counter() - t0:.2f}s")
        cfg = make_cfg(limits)
        T = data["noisy"].shape[0]
    else:
        cfg = make_cfg(dict(position_limit_squared=0.03,
                            normal_limit_squared=0.5))

    to_chw = lambda a: np.moveaxis(a, -1, 0).astype(np.float32)

    if args.scenes_root:
        from .io.dataset import discover_scenes
        from .pipeline.streaming import stream_scenes

        scenes = discover_scenes(args.scenes_root)
        if not scenes:
            print(f"No scenes found under {args.scenes_root}")
            return 1
        # Geometry + per-scene reprojection thresholds come from each
        # scene's own camera_matrices.h inside stream_scenes (the reference
        # bakes them per scene at compile time, bmfr.cpp:39-42, :226-227).
        first = scenes[0]
        print(f"Streaming {len(scenes)} scenes "
              f"({first.width}x{first.height}, {first.frame_count} frames) "
              f"concurrently across {len(jax.devices())} device(s).")
        t1 = time.perf_counter()
        outs = stream_scenes(cfg, scenes, chunk_frames=args.chunk_frames)
        dt = time.perf_counter() - t1
        frames = sum(o.shape[0] for o in outs)
        print(f"{frames} frames in {dt:.2f}s "
              f"({dt / max(frames, 1) * 1e3:.2f} ms/frame aggregate)")
        if not args.no_output:
            _write_outputs_parallel(
                args.output,
                [(f"{os.path.basename(sd.path.rstrip('/'))}_output{t}.png",
                  res[t]) for sd, res in zip(scenes, outs)
                 for t in range(res.shape[0])])
        return 0

    print("Run and profile kernels.")
    prof = ProfilingInfo("Full frame (all 5 stages)")
    if args.mode == "stream":
        from .pipeline.streaming import stream_scene

        def loader(frames):
            return {k: data[k][frames] for k in
                    ("normals", "positions", "noisy", "albedo",
                     "camera_matrices", "pixel_offsets")}

        t1 = time.perf_counter()
        res = stream_scene(cfg, loader=loader, frame_count=T,
                           chunk_frames=args.chunk_frames)
        prof.append((time.perf_counter() - t1) * 1e3 / T)
        results = [res[t] for t in range(T)]
    elif args.mode == "scan":
        from . import denoise_sequence

        seq = FrameInputs(
            normals=jnp.asarray(np.moveaxis(data["normals"], -1, 1)),
            positions=jnp.asarray(np.moveaxis(data["positions"], -1, 1)),
            noisy=jnp.asarray(np.moveaxis(data["noisy"], -1, 1)),
            albedo=jnp.asarray(np.moveaxis(data["albedo"], -1, 1)),
        )
        cams = jnp.asarray(data["camera_matrices"])
        offs = jnp.asarray(data["pixel_offsets"])

        run = jax.jit(lambda s, c, o: denoise_sequence(cfg, s, c, o))
        timed(run, seq, cams, offs)   # compile + run
        secs, out = timed(run, seq, cams, offs)
        prof.append(secs * 1e3 / T)
        results = [np.asarray(out[t]) for t in range(T)]
    else:
        step = make_denoise_frame(cfg, donate=False)
        state = TemporalState.initial(cfg)
        results = []
        for t in range(T):
            inputs = FrameInputs(
                normals=jnp.asarray(to_chw(data["normals"][t])),
                positions=jnp.asarray(to_chw(data["positions"][t])),
                noisy=jnp.asarray(to_chw(data["noisy"][t])),
                albedo=jnp.asarray(to_chw(data["albedo"][t])),
            )
            prev_cam = jnp.asarray(data["camera_matrices"][max(t - 1, 0)])
            off = jnp.asarray(data["pixel_offsets"][t])
            jax.block_until_ready(inputs)
            t1 = time.perf_counter()
            state, result = jax.block_until_ready(
                step(state, inputs, prev_cam, off, jnp.int32(t)))
            if t > 0:  # frame 0 includes compilation
                prof.append((time.perf_counter() - t1) * 1e3)
            results.append(np.asarray(result))

    print_report([prof])

    if "clean" in data:
        # compare in the output (tone-mapped) domain, like-for-like
        vals = []
        for t, r in enumerate(results):
            clean_tone = np.clip(
                np.power(np.maximum(0.0, data["clean"][t]), 0.454545), 0, 1)
            vals.append(psnr(np.moveaxis(r, 0, -1), clean_tone))
        print(f"PSNR vs clean reference (tone-mapped): mean "
              f"{np.mean(vals):.2f} dB "
              f"(first {vals[0]:.2f}, last {vals[-1]:.2f})")

    if not args.no_output:
        _write_outputs_parallel(
            args.output,
            [(f"output{t}.png", r) for t, r in enumerate(results)])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
