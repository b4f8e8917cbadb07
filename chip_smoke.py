"""Smoke test of the denoiser on NVIDIA GPUs: the quickest proof that the
system still starts, compiles and computes the right thing on the card.

Run from the root of the repository:

    python chip_smoke.py                # one GPU: device, kernel, main
    python chip_smoke.py --four-cards   # four GPUs: the sharding check only

Phases, in one process (the script exits non-zero if any of them fails):

* device — JAX must find a GPU (no CPU run, no retry). Prints the card's
  name and power limit, its kind, the device count and the JAX version.
* kernel — the fused fitter (bmfr_tpu/ops/fitter_fused.py) at 1280x720
  (984 blocks), both solvers, against the XLA fitter; prints the worst
  error and ``memory_analysis()`` of the compiled 1280x720 frame step.
* main — the benchmarked configuration (bmfr_tpu.config.bench_config)
  through ``denoise_sequence`` on the synthetic orbit scene at 1280x720
  for 8 frames. Its first 4 frames, and those of the reference-exact
  configuration (float32 taps, Householder, XLA fitter), are compared with
  the NumPy oracle (bmfr_tpu/oracle/reference_vec.py). Then the CLI runs
  in scan mode and writes its PNGs to outputs/chip_smoke/.
* four-cards (only with ``--four-cards``) — 4 synthetic scenes at
  1280x720 x 16 frames through ``denoise_scenes_sharded`` on 4 GPUs, each
  compared with the same scene run unsharded on card 0.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 1280, 720

#: The fused and the XLA fitter sum their reductions in different orders.
#: Householder QR is backward stable, so the two reconstructions agree to
#: a small multiple of f32 round-off times the block's condition number.
#: The normal equations square that condition number, so Cholesky's
#: agreement is looser; both solutions carry the same 1e-2
#: regularization noise, which bounds how ill-conditioned a block gets.
KERNEL_TOL = {"householder": 1e-3, "cholesky": 3e-2}

#: PSNR floors (dB) of the TAA output (in [0, 1]) against the NumPy oracle
#: over the first 4 frames. The reference-exact path reproduces the oracle
#: to f32 round-off (119-139 dB on an H100). The benchmarked path differs
#: by design: Cholesky instead of Householder, and a bf16 TAA neighborhood
#: scan that moves the clamp bounds by up to one bf16 ulp (~0.4%) — the
#: same order as bf16 taps, which measured 61-62 dB on an H100.
ORACLE_PSNR_DB = {"reference_exact": 100.0, "bench": 50.0}


def log(msg):
    print(msg, flush=True)


def frames_of(sc):
    """Scene dict -> (FrameInputs ``[T, 3, H, W]``, cameras, offsets) on
    the default device."""
    import jax.numpy as jnp

    from bmfr_tpu import FrameInputs

    to = lambda a: jnp.asarray(np.moveaxis(a, -1, 1).astype(np.float32))
    return (FrameInputs(to(sc["normals"]), to(sc["positions"]),
                        to(sc["noisy"]), to(sc["albedo"])),
            jnp.asarray(sc["camera_matrices"]),
            jnp.asarray(sc["pixel_offsets"]))


def phase_device():
    import jax

    from bmfr_tpu.runtime import (configure_compile_cache, nvidia_smi_line,
                                  require_gpu)

    devices = require_gpu()
    log(f"nvidia-smi: {nvidia_smi_line()}")
    log(f"device_kind: {devices[0].device_kind}")
    log(f"device count: {len(devices)}")
    log(f"jax {jax.__version__}")
    log(f"compile cache: {configure_compile_cache()}")
    return devices


def phase_kernel():
    import jax
    import jax.numpy as jnp

    from bmfr_tpu import FrameInputs, TemporalState, make_denoise_frame
    from bmfr_tpu.config import bench_config
    from bmfr_tpu.io.fixtures import synthetic_sequence
    from bmfr_tpu.ops.blockify import build_feature_blocks
    from bmfr_tpu.ops.fitter import fit_blocks
    from bmfr_tpu.ops.fitter_fused import filtered_fused
    from bmfr_tpu.ops.weighted_sum import weighted_sum

    sc = synthetic_sequence(width=W, height=H, frames=4)
    c = lambda a: jnp.asarray(np.moveaxis(a[3], -1, 0).astype(np.float32))
    n, p, acc = c(sc["normals"]), c(sc["positions"]), c(sc["noisy"])
    ok = True
    for solver, tol in KERNEL_TOL.items():
        cfg = bench_config(W, H, solver=solver)
        xcfg = cfg.replace(fitter_impl="xla")

        def xla(n, p, a, f):
            tmp = build_feature_blocks(xcfg, n, p, a, f)
            w, mm = fit_blocks(xcfg, tmp, f)
            return weighted_sum(xcfg, w, mm, n, p, a, f, feature_blocks=tmp)

        fused = jax.jit(lambda n, p, a, f: filtered_fused(cfg, n, p, a, f))
        xla = jax.jit(xla)
        for frame in (3, 10):
            f = jnp.int32(frame)
            got = np.asarray(fused(n, p, acc, f))
            want = np.asarray(xla(n, p, acc, f))
            err = np.abs(got - want)
            worst = float(err.max())
            good = bool(np.isfinite(got).all()) and worst <= tol
            ok &= good
            log(f"kernel {solver} frame {frame} ({cfg.n_blocks} blocks): "
                f"max|fused - xla| {worst} (tolerance {tol}), "
                f"p99.9 {float(np.quantile(err, 0.999))}, "
                f"max|xla| {float(np.abs(want).max())} "
                f"-> {'ok' if good else 'FAIL'}")

    cfg = bench_config(W, H)
    step = make_denoise_frame(cfg)
    z = jnp.zeros((3, H, W), jnp.float32)
    compiled = step.lower(
        TemporalState.initial(cfg), FrameInputs(z, z, z, z),
        jnp.eye(4, dtype=jnp.float32), jnp.zeros((2,), jnp.float32),
        jnp.int32(1)).compile()
    log(f"memory_analysis of the jitted {W}x{H} step: "
        f"{compiled.memory_analysis()}")
    return ok


def phase_main():
    import jax

    from bmfr_tpu import cli, denoise_sequence
    from bmfr_tpu.config import bench_config
    from bmfr_tpu.io.fixtures import synthetic_sequence
    from bmfr_tpu.io.png import read_png
    from bmfr_tpu.metrics import psnr
    from bmfr_tpu.oracle.reference_vec import oracle_denoise_sequence_vec
    from bmfr_tpu.runtime import REPO_ROOT

    T, T_ORACLE = 8, 4
    sc = synthetic_sequence(width=W, height=H, frames=T)
    inputs, cams, offs = frames_of(sc)
    configs = {
        "bench": bench_config(W, H),
        "reference_exact": bench_config(
            W, H, warp_mode="float32", solver="householder",
            fitter_impl="xla", residual_dtype="float32"),
    }
    t0 = time.perf_counter()
    oracle = oracle_denoise_sequence_vec(
        configs["reference_exact"],
        [dict(normals=sc["normals"][t], positions=sc["positions"][t],
              noisy=sc["noisy"][t], albedo=sc["albedo"][t])
         for t in range(T_ORACLE)],
        sc["camera_matrices"], sc["pixel_offsets"])
    log(f"oracle: {T_ORACLE} frames in {time.perf_counter() - t0:.1f}s")

    ok = True
    for name, cfg in configs.items():
        t0 = time.perf_counter()
        out = np.asarray(jax.block_until_ready(jax.jit(
            lambda i, c, o: denoise_sequence(cfg, i, c, o))(
                inputs, cams, offs)))
        good = (out.shape == (T, 3, H, W) and bool(np.isfinite(out).all()))
        log(f"main {name} ({cfg.warp_mode} taps, {cfg.fitter_impl} "
            f"{cfg.solver} fitter, {cfg.residual_dtype} residual): "
            f"{T} frames {out.shape} in {time.perf_counter() - t0:.1f}s "
            f"(compile included), finite={bool(np.isfinite(out).all())}")
        floor = ORACLE_PSNR_DB[name]
        for t in range(T_ORACLE):
            got = np.moveaxis(out[t], 0, -1)
            want = oracle[t]["result"]
            db = psnr(got, want)
            good &= db >= floor
            log(f"  frame {t}: PSNR vs oracle {db} dB (floor {floor}), "
                f"max|diff| {float(np.abs(got - want).max())}")
        log(f"main {name}: {'ok' if good else 'FAIL'}")
        ok &= good

    outdir = os.path.join(REPO_ROOT, "outputs", "chip_smoke")
    rc = cli.main(["--synthetic", "--mode", "scan", "--width", str(W),
                   "--height", str(H), "--frames", str(T),
                   "--output", outdir, "--fitter-impl", "fused",
                   "--solver", "cholesky", "--residual-dtype", "bfloat16"])
    pngs = sorted(f for f in os.listdir(outdir) if f.endswith(".png"))
    shape = read_png(os.path.join(outdir, "output0.png")).shape
    good = rc == 0 and len(pngs) >= T and shape == (H, W, 3)
    log(f"cli: rc={rc}, {len(pngs)} PNGs in {outdir}, output0.png {shape} "
        f"-> {'ok' if good else 'FAIL'}")
    return ok and good


def phase_four_cards(devices):
    from bmfr_tpu.config import bench_config

    if len(devices) != 4:
        log(f"four-cards: needs 4 GPUs, found {len(devices)}")
        return False
    return four_cards_check(bench_config(W, H), devices, frames=16)


def four_cards_check(cfg, devices, frames):
    """One synthetic scene per device, sharded, vs each scene alone on
    ``devices[0]``, with the tolerances of tests/test_sharding.py."""
    import jax

    from bmfr_tpu import FrameInputs, denoise_sequence
    from bmfr_tpu.io.fixtures import synthetic_sequence
    from bmfr_tpu.parallel import denoise_scenes_sharded, make_scene_mesh

    S = len(devices)
    kinds = [("orbit", 0), ("corridor", 3), ("swing", 5), ("orbit", 7)]
    scenes = [synthetic_sequence(width=cfg.image_width,
                                 height=cfg.image_height, frames=frames,
                                 scene=k, seed=s)
              for k, s in (kinds * S)[:S]]
    stack = lambda key: np.stack([np.moveaxis(sc[key], -1, 1).astype(
        np.float32) for sc in scenes])
    inputs = FrameInputs(stack("normals"), stack("positions"),
                         stack("noisy"), stack("albedo"))
    cams = np.stack([sc["camera_matrices"] for sc in scenes])
    offs = np.stack([sc["pixel_offsets"] for sc in scenes])

    mesh = make_scene_mesh(devices)
    t0 = time.perf_counter()
    with mesh:
        sharded = np.asarray(jax.block_until_ready(
            denoise_scenes_sharded(cfg, mesh, inputs, cams, offs)))
    log(f"four-cards: {S} scenes x {frames} frames at "
        f"{cfg.image_width}x{cfg.image_height} sharded over {S} devices in "
        f"{time.perf_counter() - t0:.1f}s (compile included)")
    single = jax.jit(lambda i, c, o: denoise_sequence(cfg, i, c, o))
    ok = True
    for s in range(S):
        one = np.asarray(single(*jax.device_put(
            (jax.tree.map(lambda a: a[s], inputs), cams[s], offs[s]),
            devices[0])))
        d = np.abs(sharded[s] - one)
        if cfg.residual_dtype == "bfloat16":
            # a bf16-quantized TAA clamp bound turns round-off into at
            # most one bf16 ulp, rarely (tests/test_sharding.py)
            good = d.max() <= 4e-3 and (d > 1e-5).sum() <= d.size // 10_000
        else:
            good = bool(np.all(d <= 1e-5 + 1e-5 * np.abs(one)))
        ok &= bool(good)
        log(f"  scene {s}: max|sharded - single| {float(d.max())}, "
            f"{int((d > 1e-5).sum())} of {d.size} above 1e-5 "
            f"-> {'ok' if good else 'FAIL'}")
    return ok


def run_phase(name, fn, *args):
    log(f"== phase {name}")
    t0 = time.perf_counter()
    try:
        ok = fn(*args)
    except Exception:  # noqa: BLE001 - a failed phase is reported, not raised
        traceback.print_exc(file=sys.stdout)
        ok = False
    log(f"== phase {name}: {'ok' if ok else 'FAILED'} "
        f"({time.perf_counter() - t0:.1f}s)")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharding check")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import bmfr_tpu
    except ImportError as e:
        log(f"chip_smoke.py must run from the root of the repository: {e}")
        return 2
    if not os.path.dirname(os.path.abspath(bmfr_tpu.__file__)).startswith(
            HERE + os.sep):
        log(f"bmfr_tpu comes from {bmfr_tpu.__file__}, not from {HERE}")
        return 2

    log("== phase device")
    try:
        devices = phase_device()
    except (SystemExit, Exception) as e:  # noqa: BLE001
        log(f"== phase device: FAILED ({e})")
        return 1
    log("== phase device: ok")

    if args.four_cards:
        ok = run_phase("four-cards", phase_four_cards, devices)
    else:
        ok = run_phase("kernel", phase_kernel)
        ok = run_phase("main", phase_main) and ok
    if not ok:
        log("chip_smoke: FAILED")
        return 1
    print(result_line(devices), flush=True)
    return 0


def result_line(devices):
    """The contract's last line: the devices as JAX reports them."""
    from bmfr_tpu.runtime import device_record

    return json.dumps({"ok": True, "device": device_record(devices)})


if __name__ == "__main__":
    sys.exit(main())
