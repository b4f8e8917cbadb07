"""Round-2 regression tests: solver dispatch, device timing, small-block
fused fitter, fidelity skip rows, reference discovery."""

import numpy as np
import pytest

import jax.numpy as jnp

from bmfr_tpu.config import BMFRConfig
from bmfr_tpu.ops.blockify import build_feature_blocks
from bmfr_tpu.ops.fitter import fit_blocks
from tests.conftest import to_chw


@pytest.fixture(scope="module")
def tiny_blocks(request):
    from bmfr_tpu.io.fixtures import synthetic_sequence

    cfg = BMFRConfig(image_width=64, image_height=48,
                     position_limit_squared=0.03, normal_limit_squared=0.5,
                     fitter_impl="xla").validate()
    sc = synthetic_sequence(width=64, height=48, frames=1, seed=3)
    tmp = build_feature_blocks(
        cfg, jnp.asarray(to_chw(sc["normals"][0])),
        jnp.asarray(to_chw(sc["positions"][0])),
        jnp.asarray(to_chw(sc["noisy"][0])), jnp.int32(0))
    return cfg, tmp


class TestSolverDispatch:
    """cfg.solver and cfg.fitter_impl must both reach the code that runs
    (the round-1 'cholesky' fidelity rows were byte-identical to
    Householder because a kernel was dispatched before the solver
    check)."""

    def test_cholesky_differs_from_householder(self, tiny_blocks):
        cfg, tmp = tiny_blocks
        w_h, _ = fit_blocks(cfg, tmp, jnp.int32(0))
        w_c, _ = fit_blocks(cfg.replace(solver="cholesky"), tmp, jnp.int32(0))
        # same least-squares solution mathematically...
        np.testing.assert_allclose(np.asarray(w_c), np.asarray(w_h),
                                   rtol=0, atol=5e-2)
        # ...but not bit-identical (different factorization path actually ran)
        assert np.abs(np.asarray(w_c) - np.asarray(w_h)).max() > 0

    @pytest.mark.parametrize("impl", ["xla", "fused"])
    def test_fitter_impl_selects_the_path(self, tiny_blocks, impl,
                                          monkeypatch):
        """fitter_impl='fused' runs the fused kernel and nothing of the
        XLA fitter; 'xla' never touches the kernel."""
        import bmfr_tpu.ops.fitter_fused as ff
        import bmfr_tpu.pipeline.denoise as dn
        from bmfr_tpu import FrameInputs, TemporalState, denoise_frame

        cfg, _ = tiny_blocks
        cfg = cfg.replace(fitter_impl=impl, pallas_interpret=True)
        calls = []

        def spy(name, fn):
            def wrapped(*a, **k):
                calls.append(name)
                return fn(*a, **k)
            return wrapped

        monkeypatch.setattr(ff, "filtered_fused",
                            spy("fused", ff.filtered_fused))
        monkeypatch.setattr(dn, "fit_blocks", spy("xla", dn.fit_blocks))
        z = jnp.full((3, 48, 64), 0.5, jnp.float32)
        _, out = denoise_frame(cfg, TemporalState.initial(cfg),
                               FrameInputs(z, z, z, z), jnp.eye(4),
                               jnp.zeros(2), jnp.int32(0))
        assert calls == [impl]
        assert np.isfinite(np.asarray(out["result"])).all()

    def test_fused_kernel_honours_the_solver(self, tiny_blocks):
        """The fused kernel's Cholesky and Householder solutions agree
        like the XLA ones do, but are not the same computation."""
        from bmfr_tpu.io.fixtures import synthetic_sequence
        from bmfr_tpu.ops.fitter_fused import filtered_fused

        cfg, _ = tiny_blocks
        cfg = cfg.replace(fitter_impl="fused", pallas_interpret=True)
        sc = synthetic_sequence(width=64, height=48, frames=1, seed=3)
        planes = [jnp.asarray(to_chw(sc[k][0]))
                  for k in ("normals", "positions", "noisy")]
        out = {s: np.asarray(filtered_fused(cfg.replace(solver=s), *planes,
                                            jnp.int32(0)))
               for s in ("householder", "cholesky")}
        d = np.abs(out["householder"] - out["cholesky"])
        assert 0 < d.max() < 5e-2


class TestDeviceTiming:
    def test_timed_blocks_until_ready(self):
        from bmfr_tpu.profiling import timed

        x = jnp.arange(12.0).reshape(3, 4)
        secs, out = timed(lambda a: a * 2.0, x)
        assert secs >= 0.0
        np.testing.assert_array_equal(np.asarray(out), np.asarray(x) * 2.0)

    def test_bench_times_with_block_until_ready(self):
        """The benchmark times complete device work: every timed run goes
        through profiling.timed (block_until_ready), and nothing is
        fetched to the host as a fence."""
        import inspect

        import bench
        from bmfr_tpu import profiling

        assert "block_until_ready" in inspect.getsource(profiling.timed)
        src = inspect.getsource(bench.main)
        assert "times = [timed(run, *args)[0]" in src
        assert "jnp.sum" not in src


class TestSmallBlockFitter:
    @pytest.mark.parametrize("block_edge", [8, 16, 32])
    def test_fused_fitter_matches_xla_for_any_block_edge(self, block_edge):
        """block_pixels=64 (edge 8) is below a warp's width of lanes per
        column; interpret mode must agree with the XLA path for every
        supported edge, weights and mins/maxs folded into the filtered
        image."""
        from bmfr_tpu.io.fixtures import synthetic_sequence
        from bmfr_tpu.ops.fitter_fused import filtered_fused
        from bmfr_tpu.ops.weighted_sum import weighted_sum

        cfg = BMFRConfig(image_width=64, image_height=48,
                         position_limit_squared=0.03,
                         normal_limit_squared=0.5,
                         block_edge=block_edge).validate()
        sc = synthetic_sequence(width=64, height=48, frames=1, seed=5)
        n, p, a = (jnp.asarray(to_chw(sc[k][0]))
                   for k in ("normals", "positions", "noisy"))
        f = jnp.int32(0)
        tmp = build_feature_blocks(cfg, n, p, a, f)
        w, mm = fit_blocks(cfg, tmp, f)
        want = weighted_sum(cfg, w, mm, n, p, a, f, feature_blocks=tmp)
        got = filtered_fused(cfg.replace(fitter_impl="fused",
                                         pallas_interpret=True), n, p, a, f)
        # (block_edge=8 gives 64x13 systems — markedly worse conditioned
        # than the default 1024x13, so summation-order noise is larger)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-3, atol=1e-3)


class TestFidelityHarness:
    def test_sweep_skips_scene_without_reference(self):
        from bmfr_tpu.fidelity import print_report, run_sweep
        from bmfr_tpu.io.fixtures import synthetic_sequence

        sc = synthetic_sequence(width=64, height=48, frames=2, seed=0)
        scene = {k: v for k, v in sc.items()
                 if k not in ("clean", "clean_aa")}
        base = BMFRConfig(image_width=64, image_height=48,
                          position_limit_squared=0.03,
                          normal_limit_squared=0.5)
        rows = run_sweep({"noref": scene}, base)
        assert len(rows) == 1 and rows[0]["skipped"]
        print_report(rows)  # must not raise on skipped rows

    def test_sweep_against_opencl_pngs_only(self):
        """A scene with only reference-output PNGs (no clean EXRs) still
        produces the vs-OpenCL PSNR column."""
        from bmfr_tpu.fidelity import run_sweep
        from bmfr_tpu.io.fixtures import synthetic_sequence

        sc = synthetic_sequence(width=64, height=48, frames=2, seed=1)
        clean_tone = np.clip(
            np.power(np.maximum(0.0, sc.pop("clean")), 0.454545), 0, 1)
        sc.pop("clean_aa", None)
        sc["opencl"] = clean_tone  # stand-in for decoded output PNGs
        base = BMFRConfig(image_width=64, image_height=48,
                          position_limit_squared=0.03,
                          normal_limit_squared=0.5)
        cfgs = {"default": base}
        rows = run_sweep({"s": sc}, base, configs=cfgs)
        assert rows[0]["opencl_psnr_mean"] > 15.0
        assert "psnr_mean" not in rows[0]


class TestReferenceDiscovery:
    def test_load_references_finds_exr_and_png(self, tmp_path):
        from bmfr_tpu.io import native
        if not native.available():
            pytest.skip("native IO library not built")
        from bmfr_tpu.io.dataset import SceneDescriptor

        r = np.random.RandomState(0)
        clean = r.rand(2, 16, 24, 3).astype(np.float32)
        png = (r.rand(2, 16, 24, 3) * 255).astype(np.uint8)
        (tmp_path / "outputs").mkdir()
        for t in range(2):
            native.write_exr(str(tmp_path / f"reference{t}.exr"), clean[t])
            native.write_png(str(tmp_path / "outputs" / f"output{t}.png"),
                             png[t])
        sd = SceneDescriptor(path=str(tmp_path), frame_count=2,
                             width=24, height=16)
        refs = sd.load_references()
        np.testing.assert_array_equal(refs["clean"], clean)
        np.testing.assert_allclose(refs["opencl"], png / 255.0, atol=1e-6)

    def test_load_references_empty_when_absent(self, tmp_path):
        from bmfr_tpu.io.dataset import SceneDescriptor

        sd = SceneDescriptor(path=str(tmp_path), frame_count=1)
        assert sd.load_references() == {}
