"""Benchmark: full-resolution denoise throughput on the GPU.

Measures the steady-state per-frame time of the complete 5-stage chain at
the reference workload shape — 1280x720, 1 spp, 60-frame animation
(opencl/bmfr.cpp:39-42) — with all inputs device-resident, mirroring the
reference's profiling scope ("in real use case there would not be
WriteBuffer and ReadBuffer", opencl/bmfr.cpp:415-416; total = first kernel
start to last kernel end, :497-502).

Usage: ``python bench.py`` on a machine with an NVIDIA GPU. Without one it
exits non-zero. Environment overrides: ``BENCH_FRAMES``, ``BENCH_WIDTH``,
``BENCH_HEIGHT``, ``BENCH_REPS``, ``BENCH_SCENE``, ``BENCH_WARP_MODE``,
``BENCH_FITTER``, ``BENCH_SOLVER``, ``BENCH_RESIDUAL``.

Prints the per-stage device table of one traced run, then ONE JSON line:
  {"metric": "denoise_ms_per_frame_1280x720", "value": <ms>, "unit": "ms",
   "vs_baseline": <baseline_ms / ours_ms>, "device": {...}, ...}
vs_baseline > 1.0 means faster than the 1.6 ms/frame the paper reports
(BASELINE.md).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import numpy as np

BASELINE_MS = 1.6  # reference paper headline, BASELINE.md


def main():
    import jax
    import jax.numpy as jnp

    from bmfr_tpu import FrameInputs, denoise_sequence, xplane
    from bmfr_tpu.config import bench_config
    from bmfr_tpu.io.fixtures import synthetic_sequence
    from bmfr_tpu.profiling import timed, trace
    from bmfr_tpu.runtime import (REPO_ROOT, configure_compile_cache,
                                  device_record, nvidia_smi_line,
                                  require_gpu)

    devices = require_gpu()
    configure_compile_cache()
    card = nvidia_smi_line()
    print(f"[bench] {devices[0].device_kind} x{len(devices)}; "
          f"nvidia-smi: {card}", file=sys.stderr)

    env = os.environ.get
    frames = int(env("BENCH_FRAMES", "60"))
    width = int(env("BENCH_WIDTH", "1280"))
    height = int(env("BENCH_HEIGHT", "720"))
    overrides = {field: env(var) for var, field in (
        ("BENCH_WARP_MODE", "warp_mode"), ("BENCH_FITTER", "fitter_impl"),
        ("BENCH_SOLVER", "solver"), ("BENCH_RESIDUAL", "residual_dtype"))
        if env(var)}
    cfg = bench_config(width, height, **overrides)

    # BENCH_SCENE=swing measures the teleport sequence (a hard camera
    # cut at frames//2 that breaks every reprojection test — the
    # reference must survive arbitrary cuts at fixed cost,
    # opencl/bmfr.cl:336-430).
    scene = env("BENCH_SCENE", "orbit")
    print(f"[bench] generating {frames}-frame {width}x{height} synthetic "
          f"{scene} scene...", file=sys.stderr)
    sc = synthetic_sequence(width=width, height=height, frames=frames,
                            scene=scene)

    to_tchw = lambda a: jnp.asarray(
        np.moveaxis(a, -1, 1).astype(np.float32))
    inputs = FrameInputs(
        normals=to_tchw(sc["normals"]),
        positions=to_tchw(sc["positions"]),
        noisy=to_tchw(sc["noisy"]),
        albedo=to_tchw(sc["albedo"]),
    )
    cams = jnp.asarray(sc["camera_matrices"])
    offs = jnp.asarray(sc["pixel_offsets"])

    run = jax.jit(lambda i, c, o: denoise_sequence(cfg, i, c, o))
    args = (inputs, cams, offs)

    print("[bench] compiling...", file=sys.stderr)
    t0 = time.perf_counter()
    hlo_text = run.lower(*args).compile().as_text()
    _, out = timed(run, *args)
    print(f"[bench] compile+first run {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)
    if not bool(jnp.isfinite(out).all()):
        raise SystemExit("non-finite bench output")

    # Headline = MEDIAN of reps; the spread (max-min) rides in the JSON so
    # per-change claims can be judged against run-to-run noise (the
    # reference's own discipline is mean/min/max,
    # opencl/CLUtils/CLUtils.hpp:240-361).
    reps = int(env("BENCH_REPS", "5"))
    times = [timed(run, *args)[0] / frames * 1e3 for _ in range(reps)]
    ms = float(np.median(times))
    spread = max(times) - min(times)
    print(f"[bench] per-frame times (ms): {times} -> median {ms}, "
          f"min {min(times)}, spread {spread}", file=sys.stderr)

    # Device-event scope, like the reference's CL profiling (bmfr.cpp:
    # 497-502): one traced run -> per-stage device time and busy span.
    logdir = os.path.join(REPO_ROOT, "traces", "bench")
    shutil.rmtree(logdir, ignore_errors=True)
    with trace(logdir):
        timed(run, *args)
    per, other, total = xplane.stage_device_times(logdir, hlo_text=hlo_text)
    busy, span = xplane.device_busy_span(logdir)
    if total <= 0.0:
        raise SystemExit("the trace holds no device time")
    print(f"{'stage':<28}{'ms/frame':>12}", file=sys.stderr)
    for scope, t in list(per.items()) + [("(unattributed)", other),
                                         ("total device", total)]:
        print(f"{scope:<28}{t / frames:>12.5f}", file=sys.stderr)
    print(f"[bench] device busy {busy / frames} ms/frame over a span of "
          f"{span / frames} ms/frame", file=sys.stderr)

    print(json.dumps({
        "metric": f"denoise_ms_per_frame_{width}x{height}",
        "value": ms,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / ms,
        "spread_ms": spread,
        "reps_ms": times,
        "config": f"scene={scene} warp={cfg.warp_mode} "
                  f"fitter={cfg.fitter_impl} solver={cfg.solver} "
                  f"residual={cfg.residual_dtype}",
        "stage_ms_per_frame": {k: v / frames for k, v in per.items()},
        "device_busy_ms_per_frame": busy / frames,
        "device_span_ms_per_frame": span / frames,
        "device": device_record(devices),
        "card": card,
    }))


if __name__ == "__main__":
    main()
