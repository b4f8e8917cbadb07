"""Test env: the pytest process runs on the CPU with 8 virtual devices
(multi-device sharding tests run on a virtual mesh). It stays on the CPU
even on a machine with a GPU: tests marked ``gpu`` run ``chip_smoke.py``
in a subprocess, which takes the card.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from bmfr_tpu.config import BMFRConfig  # noqa: E402
from bmfr_tpu.io.fixtures import synthetic_sequence  # noqa: E402


@pytest.fixture(scope="session")
def tiny_cfg():
    """64x48 scene: workset 64x64, margins 96x96, 3x3=9 blocks."""
    return BMFRConfig(
        image_width=64,
        image_height=48,
        position_limit_squared=0.03,
        normal_limit_squared=0.5,
        fitter_impl="xla",
    ).validate()


@pytest.fixture(scope="session")
def tiny_scene():
    return synthetic_sequence(width=64, height=48, frames=3, seed=0)


def to_chw(img_hwc):
    """[H, W, 3] -> [3, H, W] float32."""
    return np.ascontiguousarray(np.moveaxis(img_hwc, -1, 0)).astype(np.float32)
