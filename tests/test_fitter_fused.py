"""Fused per-block fitter (ops/fitter_fused.py), run in the Pallas
interpreter, against the XLA fitter path (build_feature_blocks +
fit_blocks + weighted_sum) and the NumPy oracle.

Tolerances: with Householder the two paths agree to f32 round-off scaled
by the block's conditioning (observed <= 1e-5 on O(1) colors); with
Cholesky the normal equations square the conditioning (observed <= 1e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bmfr_tpu.ops.blockify import build_feature_blocks
from bmfr_tpu.ops.fitter import fit_blocks
from bmfr_tpu.ops.fitter_fused import filtered_fused
from bmfr_tpu.ops.weighted_sum import weighted_sum
from conftest import to_chw


@functools.lru_cache(maxsize=None)
def xla_fn(cfg):
    cfg = cfg.replace(fitter_impl="xla")

    def run(n, p, a, f):
        tmp = build_feature_blocks(cfg, n, p, a, f)
        w, mm = fit_blocks(cfg, tmp, f)
        return weighted_sum(cfg, w, mm, n, p, a, f, feature_blocks=tmp)

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def fused_fn(cfg):
    cfg = cfg.replace(fitter_impl="fused", pallas_interpret=True)
    return jax.jit(lambda n, p, a, f: filtered_fused(cfg, n, p, a, f))


def both(cfg, planes, frame):
    f = jnp.int32(frame)
    return (np.asarray(fused_fn(cfg)(*planes, f)),
            np.asarray(xla_fn(cfg)(*planes, f)))


@pytest.fixture(scope="module")
def frame_planes(tiny_scene):
    return (jnp.asarray(to_chw(tiny_scene["normals"][1])),
            jnp.asarray(to_chw(tiny_scene["positions"][1])),
            jnp.asarray(to_chw(tiny_scene["noisy"][1])))


def sequence_inputs(sc):
    from bmfr_tpu.pipeline.denoise import FrameInputs

    stack = lambda k: jnp.asarray(np.stack([to_chw(x) for x in sc[k]]))
    return (FrameInputs(stack("normals"), stack("positions"),
                        stack("noisy"), stack("albedo")),
            jnp.asarray(sc["camera_matrices"]),
            jnp.asarray(sc["pixel_offsets"]))


@pytest.mark.parametrize("frame", [0, 1, 7])
def test_fused_matches_xla(tiny_cfg, frame_planes, frame):
    got, want = both(tiny_cfg, frame_planes, frame)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_fused_reduced_precision(tiny_cfg, frame_planes, dtype):
    """The kernel must keep the per-reflection storage rounding."""
    cfg = tiny_cfg.replace(tmp_data_dtype=dtype).validate()
    got, want = both(cfg, frame_planes, 1)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    # ... and the rounding must actually happen
    exact, _ = both(tiny_cfg, frame_planes, 1)
    assert np.abs(got - exact).max() > 0


def test_pipeline_fused_matches_xla(tiny_cfg, tiny_scene):
    """Full sequence: fitter_impl='fused' vs the XLA fitter."""
    from bmfr_tpu.pipeline.denoise import denoise_sequence

    inputs, cams, offs = sequence_inputs(tiny_scene)
    out_xla = denoise_sequence(tiny_cfg, inputs, cams, offs)
    out_fused = denoise_sequence(
        tiny_cfg.replace(fitter_impl="fused", pallas_interpret=True),
        inputs, cams, offs)
    np.testing.assert_allclose(np.asarray(out_fused), np.asarray(out_xla),
                               rtol=5e-4, atol=5e-4)


def test_config_rejects_unsupported_fused(tiny_cfg):
    for edge in (24, 40, 64):
        with pytest.raises(ValueError, match="block_edge 8, 16 or 32"):
            tiny_cfg.replace(fitter_impl="fused", block_edge=edge).validate()
    # the XLA fitter keeps any multiple of 8
    tiny_cfg.replace(block_edge=24).validate()
    for edge in (8, 16, 32):
        tiny_cfg.replace(fitter_impl="fused", block_edge=edge,
                         solver="cholesky").validate()


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_fused_cholesky_storage_dtypes(tiny_cfg, frame_planes, dtype):
    """Cholesky under every storage dtype, over several jitter frames;
    the reconstruction basis is the raw f32 features (opencl/bmfr.cl:
    724-729), not the quantized store."""
    cfg = tiny_cfg.replace(tmp_data_dtype=dtype, solver="cholesky")
    for frame in (0, 1, 7):
        got, want = both(cfg, frame_planes, frame)
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def test_fused_cholesky_matches_xla_cholesky(tiny_cfg, frame_planes):
    cfg = tiny_cfg.replace(solver="cholesky")
    for frame in (0, 5):
        got, want = both(cfg, frame_planes, frame)
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def test_pipeline_fused_cholesky_runs(tiny_cfg, tiny_scene):
    """Full frames with fitter_impl='fused' + solver='cholesky'."""
    from bmfr_tpu import FrameInputs, TemporalState
    from bmfr_tpu.pipeline.denoise import denoise_frame

    cfg = tiny_cfg.replace(fitter_impl="fused", solver="cholesky",
                           pallas_interpret=True).validate()
    state = TemporalState.initial(cfg)
    for t in range(2):
        inputs = FrameInputs(
            jnp.asarray(to_chw(tiny_scene["normals"][t])),
            jnp.asarray(to_chw(tiny_scene["positions"][t])),
            jnp.asarray(to_chw(tiny_scene["noisy"][t])),
            jnp.asarray(to_chw(tiny_scene["albedo"][t])))
        state, outs = denoise_frame(
            cfg, state, inputs,
            jnp.asarray(tiny_scene["camera_matrices"][max(t - 1, 0)]),
            jnp.asarray(tiny_scene["pixel_offsets"][t]), jnp.int32(t))
    res = np.asarray(outs["result"])
    assert np.isfinite(res).all()
    assert res.min() >= 0.0 and res.max() <= 1.0


@pytest.mark.parametrize("frame", range(16))
def test_every_jitter_offset(tiny_cfg, frame_planes, frame):
    """Each entry of the 16-entry block-offset table (opencl/bmfr.cl:
    267-285): the kernel's load origin and the inverse-jitter slice must
    put every pixel in the same block as the XLA layout does."""
    got, want = both(tiny_cfg, frame_planes, frame)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("block_edge", [8, 16, 32])
@pytest.mark.parametrize("solver", ["householder", "cholesky"])
def test_block_edges(frame_planes, block_edge, solver):
    """Every supported tile size and both solvers. block_edge=8 gives
    64x13 systems, far worse conditioned than 1024x13."""
    from bmfr_tpu.config import BMFRConfig

    cfg = BMFRConfig(image_width=64, image_height=48,
                     position_limit_squared=0.03, normal_limit_squared=0.5,
                     block_edge=block_edge, solver=solver).validate()
    got, want = both(cfg, frame_planes, 3)
    tol = 1e-4 if solver == "householder" else 5e-3
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


_FEATURE_SETS = {
    "first_order": (("const", "normal_x", "normal_y", "normal_z"),
                    ("world_position_x", "world_position_y",
                     "world_position_z")),
    "positions_only": (("const",),
                       ("world_position_x", "world_position_y",
                        "world_position_z", "world_position_x2",
                        "world_position_y2", "world_position_z2")),
    "custom": (("const", "normal_x"), ("world_position_x",
                                       "test_xy_product")),
}


@pytest.mark.parametrize("name", sorted(_FEATURE_SETS))
def test_feature_sets(tiny_cfg, frame_planes, name):
    """The kernel evaluates whatever basis the config names, including a
    user-registered feature."""
    from bmfr_tpu.features import register_feature

    register_feature("test_xy_product", lambda n, p: p[0] * p[1])
    not_scaled, scaled = _FEATURE_SETS[name]
    cfg = tiny_cfg.replace(features_not_scaled=not_scaled,
                           features_scaled=scaled).validate()
    got, want = both(cfg, frame_planes, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("solver", ["householder", "cholesky"])
def test_singular_blocks_give_zero_weights(tiny_cfg, solver):
    """Without the regularization noise, constant planes make every
    block's system singular: both fitters must fall back to zero weights
    (a black filtered image), never NaN."""
    cfg = tiny_cfg.replace(noise_amount=0.0, solver=solver).validate()
    H, W = cfg.image_height, cfg.image_width
    planes = (jnp.full((3, H, W), 0.5, jnp.float32),
              jnp.full((3, H, W), 2.0, jnp.float32),
              jnp.full((3, H, W), 0.25, jnp.float32))
    got, want = both(cfg, planes, 0)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("solver", ["householder", "cholesky"])
def test_constant_color_is_reproduced(tiny_cfg, frame_planes, solver):
    """A constant noisy color lies in the span of the constant feature:
    the fit must reconstruct it exactly up to round-off."""
    n, p, _ = frame_planes
    acc = jnp.full_like(n, 0.3)
    cfg = tiny_cfg.replace(solver=solver)
    got, want = both(cfg, (n, p, acc), 4)
    np.testing.assert_allclose(got, 0.3, atol=1e-3)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_fused_pipeline_matches_oracle(tiny_cfg, tiny_scene):
    """The fused Householder pipeline against the literal oracle's TAA
    output (the whole-image bound of tests/test_pipeline_vs_oracle.py)."""
    from bmfr_tpu.metrics import psnr
    from bmfr_tpu.oracle.reference_vec import oracle_denoise_sequence_vec
    from bmfr_tpu.pipeline.denoise import denoise_sequence

    sc = tiny_scene
    T = sc["noisy"].shape[0]
    oracle = oracle_denoise_sequence_vec(
        tiny_cfg, [dict(normals=sc["normals"][t],
                        positions=sc["positions"][t],
                        noisy=sc["noisy"][t], albedo=sc["albedo"][t])
                   for t in range(T)],
        sc["camera_matrices"], sc["pixel_offsets"])
    inputs, cams, offs = sequence_inputs(sc)
    out = np.asarray(denoise_sequence(
        tiny_cfg.replace(fitter_impl="fused", pallas_interpret=True),
        inputs, cams, offs))
    for t in range(T):
        db = psnr(np.moveaxis(out[t], 0, -1), oracle[t]["result"])
        assert db >= 60.0, f"frame {t}: {db:.2f} dB vs oracle"
