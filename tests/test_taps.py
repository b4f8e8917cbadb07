"""Bilinear tap fetch (ops/warp.gather_taps) over index fields like real
reprojection and its edge cases.

Every mode must return, for every in-bounds tap, the source value at that
tap: ``float32`` exactly (checked against direct NumPy indexing), the
bf16 modes as that value rounded to bf16 (so ``packed_x_bf16`` equals
``float32`` rounded). Out-of-bounds taps are don't-cares: the pipeline
masks them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bmfr_tpu.ops.gather import TAP_OFFSETS
from bmfr_tpu.ops.warp import gather_taps

C, H, W = 5, 48, 160


def make_planes(seed=0, c=C, h=H, w=W):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((c, h, w)).astype(np.float32))


def check_taps(planes, iy, ix):
    """All modes vs direct indexing on the in-bounds taps."""
    src = np.asarray(planes)
    _, h, w = src.shape
    iy_np, ix_np = np.asarray(iy), np.asarray(ix)
    bf16 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                                .astype(jnp.float32))
    got = {m: np.asarray(jax.jit(gather_taps, static_argnames="mode")(
        planes, iy, ix, mode=m))
        for m in ("float32", "packed_bf16", "packed_x_bf16")}
    for i, (dx, dy) in enumerate(TAP_OFFSETS):
        y, x = iy_np + dy, ix_np + dx
        ok = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        want = src[:, np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)]
        for mode, taps in got.items():
            ref = want if mode == "float32" else bf16(want)
            np.testing.assert_array_equal(
                np.where(ok, taps[i], 0), np.where(ok, ref, 0),
                err_msg=f"mode={mode} tap={i}")
    return got


def grid(h=H, w=W):
    yy = jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32)[:, None], (h, w))
    xx = jnp.broadcast_to(jnp.arange(w, dtype=jnp.int32)[None, :], (h, w))
    return yy, xx


def coherent_indices(seed=1, max_disp=5):
    """Smooth small-motion index field plus per-pixel jitter."""
    rng = np.random.default_rng(seed)
    y = np.arange(H)[:, None] + rng.integers(-max_disp, max_disp + 1)
    x = np.arange(W)[None, :] + rng.integers(-max_disp, max_disp + 1)
    jy = rng.integers(-2, 3, size=(H, W))
    jx = rng.integers(-2, 3, size=(H, W))
    iy = (y + np.zeros((1, W), int) + jy).astype(np.int32)
    ix = (x + np.zeros((H, 1), int) + jx).astype(np.int32)
    return jnp.asarray(iy), jnp.asarray(ix)


def test_identity_warp():
    iy, ix = grid()
    got = check_taps(make_planes(), iy, ix)
    # tap (0, 0) of the identity field is the source itself
    np.testing.assert_array_equal(got["float32"][0],
                                  np.asarray(make_planes()))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_coherent_motion(seed):
    check_taps(make_planes(seed), *coherent_indices(seed))


def test_pure_pan():
    yy, xx = grid()
    check_taps(make_planes(11), yy + 3, xx - 2)


def test_global_pan_large():
    yy, xx = grid()
    check_taps(make_planes(4), yy - 30, xx + 90)


def test_edge_clipping():
    iy, ix = coherent_indices(5)
    iy = iy.at[:4].set(-1).at[-4:].set(H - 1)
    ix = ix.at[:, :4].set(-1).at[:, -4:].set(W - 1)
    check_taps(make_planes(5), iy, ix)


def test_wild_motion():
    """Per-pixel random scatter: every pixel reads somewhere else."""
    rng = np.random.default_rng(6)
    iy = jnp.asarray(rng.integers(-1, H, size=(H, W), dtype=np.int32))
    ix = jnp.asarray(rng.integers(-1, W, size=(H, W), dtype=np.int32))
    check_taps(make_planes(6), iy, ix)


def test_all_invalid_is_safe():
    """Fully off-screen frame: values are don't-cares but must not crash."""
    iy = jnp.full((H, W), -1000, jnp.int32)
    ix = jnp.full((H, W), -1000, jnp.int32)
    got = check_taps(make_planes(7), iy, ix)
    assert got["packed_x_bf16"].shape == (4, C, H, W)


def test_vertical_screen_entry():
    """iy == -1: the row-0 taps are out of bounds, the row-1 taps must be
    source row 0."""
    yy, xx = grid()
    got = check_taps(make_planes(13), jnp.full((H, W), -1, jnp.int32), xx)
    np.testing.assert_array_equal(got["float32"][2],
                                  np.asarray(make_planes(13))[:, :1, :]
                                  .repeat(H, axis=1))


def test_nonaligned_geometry():
    """Odd heights/widths behave the same."""
    h, w = 37, 130
    yy, xx = grid(h, w)
    check_taps(make_planes(9, 3, h, w), jnp.clip(yy + 3, -5, 50), xx - 2)


def test_teleport_small_scene_pipeline(tiny_cfg):
    """The swing scene's camera cut (frames//2) at small size: bf16 taps
    keep the whole pipeline close to exact float32 taps, through the cut
    that breaks every reprojection test."""
    from bmfr_tpu import FrameInputs, denoise_sequence
    from bmfr_tpu.io.fixtures import synthetic_sequence

    sc = synthetic_sequence(width=64, height=48, frames=6, scene="swing",
                            seed=3)
    to = lambda a: jnp.asarray(np.moveaxis(a, -1, 1).astype(np.float32))
    inputs = FrameInputs(to(sc["normals"]), to(sc["positions"]),
                         to(sc["noisy"]), to(sc["albedo"]))
    cams = jnp.asarray(sc["camera_matrices"])
    offs = jnp.asarray(sc["pixel_offsets"])
    run = lambda cfg: np.asarray(jax.jit(
        lambda i, c, o: denoise_sequence(cfg, i, c, o))(inputs, cams, offs))
    exact = run(tiny_cfg)
    packed = run(tiny_cfg.replace(warp_mode="packed_x_bf16"))
    assert np.isfinite(packed).all()
    # ~0.4% relative rounding on gathered history, on [0, 1] outputs
    assert np.abs(packed - exact).max() < 0.05
    assert np.abs(packed - exact).mean() < 2e-3
