"""Fidelity harness — PSNR/SSIM sweeps across scenes and configurations.

BASELINE config 3: the reference project verifies against 4096-spp renders
offline and by eye (SURVEY §4); this harness makes the comparison a
reproducible report. It runs a matrix of configurations (solver, storage
precision, warp mode, stage bypasses) over a set of scenes, comparing the
tone-mapped outputs against each scene's clean reference, and prints a
table plus machine-readable JSON.

Usage:
    python -m bmfr_tpu.fidelity --synthetic --frames 8 --width 128 --height 96
    python -m bmfr_tpu.fidelity --scenes-root /data/bmfr  # TUNI layout
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .config import BMFRConfig
from .metrics import psnr, ssim


def default_config_matrix(base: BMFRConfig):
    """The standard sweep axes."""
    return {
        "default": base,
        "cholesky": base.replace(solver="cholesky"),
        "tmp_f16": base.replace(tmp_data_dtype="float16"),
        "warp_packed": base.replace(warp_mode="packed_x_bf16"),
        "fused": base.replace(fitter_impl="fused"),
        # the benchmarked configuration (config.bench_config): fused
        # Cholesky fitter, bf16 TAA residual — same least-squares
        # contract as Householder (opencl/bmfr.cl:549-699 is the means,
        # the LS solution is the contract)
        "bench": base.replace(fitter_impl="fused", solver="cholesky",
                              residual_dtype="bfloat16"),
        "residual_bf16": base.replace(residual_dtype="bfloat16"),
        "no_taa": base.replace(skip_taa=True),
        "first_order": base.replace(
            features_scaled=("world_position_x", "world_position_y",
                             "world_position_z")),
    }


def run_scene(cfg, scene):
    """Run the full pipeline on one scene dict; returns tone-mapped output
    ``f32[T, H, W, 3]`` in [0, 1] (the comparison domain)."""
    import jax
    import jax.numpy as jnp

    from . import FrameInputs, denoise_sequence

    to_tchw = lambda a: jnp.asarray(np.moveaxis(a, -1, 1).astype(np.float32))
    seq = FrameInputs(to_tchw(scene["normals"]), to_tchw(scene["positions"]),
                      to_tchw(scene["noisy"]), to_tchw(scene["albedo"]))
    out = jax.jit(lambda i, c, o: denoise_sequence(cfg, i, c, o))(
        seq, jnp.asarray(scene["camera_matrices"]),
        jnp.asarray(scene["pixel_offsets"]))
    return np.moveaxis(np.asarray(out), 1, -1)  # [T, H, W, 3]


def _series_metrics(out, ref, prefix=""):
    T = out.shape[0]
    vals_p = [psnr(out[t], ref[t]) for t in range(T)]
    vals_s = [ssim(out[t], ref[t]) for t in range(T)]
    return {
        f"{prefix}psnr_mean": float(np.mean(vals_p)),
        f"{prefix}psnr_first": float(vals_p[0]),
        f"{prefix}psnr_last": float(vals_p[-1]),
        f"{prefix}ssim_mean": float(np.mean(vals_s)),
    }


def evaluate_scene(cfg, scene, clean_tone, opencl=None):
    """Metrics of one config on one scene: vs the tone-mapped clean
    reference, and (when present) vs the OpenCL implementation's own output
    PNGs — the BASELINE "within 0.1 dB of the OpenCL reference" axis."""
    out = run_scene(cfg, scene)
    m = _series_metrics(out, clean_tone) if clean_tone is not None else {}
    if opencl is not None:
        m.update(_series_metrics(out, opencl, prefix="opencl_"))
    return m


def _scene_cfg(base_cfg, scene):
    """Per-scene config: geometry + the scene's own reprojection discard
    thresholds (the reference bakes them per scene, opencl/bmfr.cpp:226-227)."""
    c = base_cfg.replace(
        image_width=scene["noisy"].shape[2],
        image_height=scene["noisy"].shape[1])
    if "position_limit_squared" in scene:
        c = c.replace(
            position_limit_squared=float(scene["position_limit_squared"]),
            normal_limit_squared=float(scene["normal_limit_squared"]))
    return c


def run_sweep(scenes, base_cfg, configs=None):
    """scenes: dict name -> scene data dict with a 'clean' (and optionally
    'clean_aa' / 'opencl') reference. Scenes without any reference are
    reported as skipped rows. Returns list of report rows."""
    rows = []
    for sname, scene in scenes.items():
        scfg = _scene_cfg(base_cfg, scene)
        sweep = configs or default_config_matrix(scfg)
        # prefer the supersampled reference when available — TAA output is
        # antialiased, so comparing against an aliased render understates it
        clean = scene.get("clean_aa", scene.get("clean"))
        opencl = scene.get("opencl")
        if clean is None and opencl is None:
            rows.append(dict(scene=sname, config="-", skipped=True,
                             note="no clean/opencl reference on disk"))
            continue
        clean_tone = base_p = None
        if clean is not None:
            clean_tone = np.clip(
                np.power(np.maximum(0.0, clean), 0.454545), 0, 1)
            noisy_tone = np.clip(np.power(np.maximum(
                0.0, scene["albedo"] * scene["noisy"]), 0.454545), 0, 1)
            base_p = float(np.mean(
                [psnr(noisy_tone[t], clean_tone[t])
                 for t in range(clean_tone.shape[0])]))
        for cname, cfg in sweep.items():
            m = evaluate_scene(cfg.validate(), scene, clean_tone, opencl)
            rows.append(dict(scene=sname, config=cname,
                             noisy_psnr=base_p, **m))
    return rows


def print_report(rows):
    hdr = (f"{'scene':<14}{'config':<14}{'noisy dB':>9}{'PSNR dB':>9}"
           f"{'first':>8}{'last':>8}{'SSIM':>8}{'vs-OCL dB':>10}")
    print(hdr)
    print("-" * len(hdr))

    def fmt(r, key, width, prec):
        v = r.get(key)
        return f"{v:>{width}.{prec}f}" if v is not None else " " * width

    for r in rows:
        if r.get("skipped"):
            print(f"{r['scene']:<14}{'(skipped)':<14}{r['note']}")
            continue
        print(f"{r['scene']:<14}{r['config']:<14}"
              + fmt(r, "noisy_psnr", 9, 2) + fmt(r, "psnr_mean", 9, 2)
              + fmt(r, "psnr_first", 8, 2) + fmt(r, "psnr_last", 8, 2)
              + fmt(r, "ssim_mean", 8, 3) + fmt(r, "opencl_psnr_mean", 10, 2))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--scenes-root")
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--json-out")
    p.add_argument("--interpret", action="store_true",
                   help="run Pallas kernels in the interpreter (CPU)")
    args = p.parse_args(argv)

    scenes = {}
    if args.scenes_root:
        from .io.dataset import discover_scenes

        frames = list(range(args.frames)) if args.frames else None
        for sd in discover_scenes(args.scenes_root):
            data = sd.load_frames(frames=frames)
            # 4096-spp clean EXRs and/or the OpenCL implementation's output
            # PNGs, whichever the mirror ships (README.md:10-12); scenes
            # with neither are reported as skipped by run_sweep.
            data.update(sd.load_references(frames=frames))
            scenes[sd.path.rstrip("/").split("/")[-1]] = data
    else:
        from .io.fixtures import synthetic_sequence

        for seed, sctype, name in [(0, "orbit", "orbit-a"),
                                   (7, "orbit", "orbit-b"),
                                   (3, "corridor", "corridor"),
                                   (5, "swing", "swing")]:
            scenes[name] = synthetic_sequence(
                width=args.width, height=args.height,
                frames=args.frames, seed=seed, aa_samples=8,
                scene=sctype)

    base = BMFRConfig(
        image_width=args.width, image_height=args.height,
        position_limit_squared=0.03, normal_limit_squared=0.5,
        pallas_interpret=args.interpret)
    rows = run_sweep(scenes, base)
    print_report(rows)
    if args.json_out:
        import jax

        # record the capture conditions so artifacts are self-describing
        # (a CPU small-res sweep must not read as the full-res record)
        meta = dict(width=args.width, height=args.height,
                    frames=args.frames, backend=jax.default_backend())
        with open(args.json_out, "w") as f:
            json.dump({"meta": meta, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
