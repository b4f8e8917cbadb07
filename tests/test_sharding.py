"""Multi-chip scale-out: scene-DP shard_map on the 8-device virtual mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bmfr_tpu import FrameInputs, denoise_sequence
from bmfr_tpu.parallel import make_scene_mesh, denoise_scenes_sharded


@pytest.fixture(scope="module")
def cfg():
    from bmfr_tpu.config import BMFRConfig

    return BMFRConfig(
        image_width=64, image_height=48,
        position_limit_squared=0.03, normal_limit_squared=0.5,
        fitter_impl="xla").validate()


def _scene_batch(cfg, S, T, seed=0):
    r = np.random.RandomState(seed)
    H, W = cfg.image_height, cfg.image_width
    mk = lambda: jnp.asarray(r.rand(S, T, 3, H, W).astype(np.float32))
    inputs = FrameInputs(mk(), mk(), mk(), mk())
    cams = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (S, T, 4, 4))
    offs = jnp.zeros((S, T, 2), jnp.float32) + 0.5
    return inputs, cams, offs


def test_eight_device_mesh_available():
    assert len(jax.devices()) == 8, (
        "tests require the 8-device virtual CPU mesh (conftest)")


@pytest.mark.parametrize("variant", [
    {},
    {"solver": "cholesky"},
    {"residual_dtype": "bfloat16"},
    {"tmp_data_dtype": "float16"},
])
def test_sharded_matches_single_device(cfg, variant):
    """shard_map runs with check_vma=False (pallas out_shapes carry no
    varying-mesh-axes annotation), so static checking is off for the
    whole sharded program — every shipped config variant therefore needs
    this numerical sharded==single-device proof, not just the default."""
    cfg = cfg.replace(**variant).validate()
    S, T = 8, 2
    inputs, cams, offs = _scene_batch(cfg, S, T)
    mesh = make_scene_mesh()
    with mesh:
        sharded = np.asarray(
            denoise_scenes_sharded(cfg, mesh, inputs, cams, offs))
    # single-device reference: the same jitted program, plain vmap over
    # scenes
    single = np.asarray(jax.jit(jax.vmap(
        lambda i, c, o: denoise_sequence(cfg, i, c, o)))(inputs, cams, offs))
    # The two programs fuse differently, so the XLA paths carry ~1e-7 of
    # contraction-order noise. With residual_dtype=bfloat16 the TAA AABB
    # bound is quantized: noise that moves a pixel across the FIXED
    # quantized bound becomes an |x - bound| difference of up to one
    # bf16 ulp (measured: 3 px at <=2.5e-5 over 8 scenes) — clamp-
    # boundary amplification, not a sharding defect. Bound the allowance
    # by one bf16 ulp at unit scale and require it to stay rare.
    if variant.get("residual_dtype") == "bfloat16":
        d = np.abs(sharded - single)
        assert d.max() <= 4e-3, d.max()
        assert (d > 1e-5).sum() <= d.size // 10_000, (d > 1e-5).sum()
    else:
        np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-5)


def test_sharded_multi_scene_per_chip(cfg):
    # 16 scenes on 8 devices = 2 per chip
    S, T = 16, 1
    inputs, cams, offs = _scene_batch(cfg, S, T, seed=1)
    mesh = make_scene_mesh()
    with mesh:
        out = np.asarray(
            denoise_scenes_sharded(cfg, mesh, inputs, cams, offs))
    assert out.shape == (S, T, 3, cfg.image_height, cfg.image_width)
    assert np.isfinite(out).all()
