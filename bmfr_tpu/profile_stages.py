"""Per-stage profiling runner — the reference's per-kernel report.

The reference times each of the five kernels per frame with GPU event
timers and prints mean/min/max/total tables (opencl/bmfr.cpp:386-412,
:489-517). This module reproduces that view: each stage is jitted and
timed standalone over repeated runs with readback fencing.

Note: standalone per-stage times over-count shared work (each timed call
pays its own dispatch + the tap gathers are shared between the temporal
stages inside the fused pipeline), so the rows do not sum to the fused
frame time — the "Full frame" row is the ground truth, the per-stage rows
show relative weight, exactly like the reference's per-kernel events vs
its "Total time in all kernels" row.

``--xplane`` switches to true on-device attribution: the fused frame is
run under an XLA profiler trace and every device op's duration is
grouped by its pipeline stage scope (bmfr_tpu/xplane.py) — these rows DO
sum to ~the fused frame time, the exact analogue of the reference's CL
event report.

Usage: python -m bmfr_tpu.profile_stages [--width W --height H] [--xplane]
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np


def xplane_report(cfg, state, inputs, cam, off, frame, logdir, reps=3):
    """Trace the fused frame and print per-stage *device* milliseconds."""
    import shutil

    import jax

    from . import xplane
    from .pipeline.denoise import denoise_frame
    from .profiling import trace

    jfn = jax.jit(lambda *a: denoise_frame(cfg, *a)[1]["result"])
    args = (state, inputs, cam, off, frame)
    compiled = jfn.lower(*args).compile()
    jax.block_until_ready(jfn(*args))  # warm
    shutil.rmtree(logdir, ignore_errors=True)
    with trace(logdir):
        for _ in range(reps):
            jax.block_until_ready(jfn(*args))
    per, other, total = xplane.stage_device_times(
        logdir, hlo_text=compiled.as_text())
    print(f"Per-stage DEVICE time over {reps} frames "
          f"(xplane trace, ms/frame):")
    print(f"{'stage':<40}{'ms/frame':>12}")
    print("-" * 52)
    for scope, ms in per.items():
        print(f"{scope:<40}{ms / reps:>12.3f}")
    print(f"{'(unattributed)':<40}{other / reps:>12.3f}")
    print(f"{'total device':<40}{total / reps:>12.3f}")
    return per, other, total


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--warp-mode", default="packed_x_bf16")
    p.add_argument("--fitter-impl", default="xla", choices=["xla", "fused"])
    p.add_argument("--solver", default="householder",
                   choices=["householder", "cholesky"])
    p.add_argument("--xplane", action="store_true",
                   help="per-stage device times from an XLA profiler "
                        "trace (sums to ~the fused frame time)")
    p.add_argument("--trace-dir", default=None,
                   help="profiler output directory (default: traces/ "
                        "in the checkout)")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from .config import BMFRConfig
    from .io.fixtures import synthetic_sequence
    from .ops.accumulate import accumulate_filtered_data
    from .ops.blockify import build_feature_blocks
    from .ops.fitter import fit_blocks
    from .ops.reproject import accumulate_noisy_data
    from .ops.taa import taa
    from .ops.weighted_sum import weighted_sum
    from .pipeline.denoise import FrameInputs, denoise_frame
    from .profiling import ProfilingInfo, print_report

    H, W = args.height, args.width
    cfg = BMFRConfig(image_width=W, image_height=H,
                     position_limit_squared=0.03, normal_limit_squared=0.5,
                     warp_mode=args.warp_mode, fitter_impl=args.fitter_impl,
                     solver=args.solver).validate()
    # profile a steady mid-sequence transition (the 0->1 transition of
    # the synthetic scene is a camera teleport, not the typical frame)
    sc = synthetic_sequence(width=W, height=H, frames=5)
    t = 4
    c = lambda a: jnp.asarray(np.moveaxis(a, -1, 0).astype(np.float32))
    normals, positions, noisy, albedo = (
        c(sc["normals"][t]), c(sc["positions"][t]), c(sc["noisy"][t]),
        c(sc["albedo"][t]))
    pn, pp, pnz = (c(sc["normals"][t - 1]), c(sc["positions"][t - 1]),
                   c(sc["noisy"][t - 1]))
    pspp = jnp.ones((H, W), jnp.uint8)
    cam = jnp.asarray(sc["camera_matrices"][t - 1])
    off = jnp.asarray(sc["pixel_offsets"][t])
    frame = jnp.int32(t)

    if args.xplane:
        import os

        from .pipeline.state import TemporalState
        from .runtime import REPO_ROOT

        state = TemporalState(pn, pp, pnz, pspp, pnz, pnz)
        inputs = FrameInputs(normals, positions, noisy, albedo)
        xplane_report(cfg, state, inputs, cam, off, frame,
                      args.trace_dir or os.path.join(REPO_ROOT, "traces"),
                      reps=args.reps)
        return 0

    rows = []

    def bench(label, fn, *fargs):
        jfn = jax.jit(fn)
        out = jax.block_until_ready(jfn(*fargs))
        info = ProfilingInfo(label)
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(jfn(*fargs))
            info.append((time.perf_counter() - t0) * 1e3)
        rows.append(info)
        return out

    k1 = bench("Accumulation of noisy data (K1)",
               functools.partial(accumulate_noisy_data, cfg),
               normals, positions, noisy, pn, pp, pnz, pspp, cam, off,
               frame)
    tmp = bench("Feature build + block layout",
                functools.partial(build_feature_blocks, cfg),
                normals, positions, k1["accum"], frame)
    w, mm = bench("Fitting feature buffers to noisy data (K2)",
                  functools.partial(fit_blocks, cfg), tmp, frame)
    filt = bench("Weighted sum (K3)",
                 functools.partial(weighted_sum, cfg),
                 w, mm, normals, positions, noisy, frame)
    k4 = bench("Accumulation of filtered data (K4)",
               functools.partial(accumulate_filtered_data, cfg),
               filt, k1["prev_pixels"], k1["accept"], albedo, k1["spp"],
               pnz, frame)
    bench("TAA (K5)", functools.partial(taa, cfg),
          k1["prev_pixels"], k4[1], pnz, frame)

    # fused full frame (the ground-truth number)
    from .pipeline.state import TemporalState

    state = TemporalState(pn, pp, pnz, pspp, pnz, pnz)
    inputs = FrameInputs(normals, positions, noisy, albedo)
    bench("Total: full fused frame (all 5 stages)",
          lambda *a: denoise_frame(cfg, *a)[1]["result"],
          state, inputs, cam, off, frame)

    print(f"Per-stage profile at {W}x{H} on {jax.devices()[0]} "
          f"(standalone jits; see module docstring)")
    print_report(rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
