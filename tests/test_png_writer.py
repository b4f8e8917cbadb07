"""The stdlib PNG writer (io/png.write_png) and the CLI's PNG path when the
native library is not built."""

import numpy as np
import pytest

from bmfr_tpu.io.png import read_png, write_png


@pytest.mark.parametrize("shape", [(17, 23, 3), (9, 31), (4, 5, 4)])
def test_write_png_round_trips(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / "x.png")
    write_png(p, img)
    got = read_png(p)
    np.testing.assert_array_equal(got.reshape(img.shape), img)


def test_exr_write_png_without_native_library(tmp_path, monkeypatch):
    from bmfr_tpu.io import exr, native

    monkeypatch.setattr(native, "available", lambda: False)
    img = np.linspace(0.0, 1.0, 8 * 6 * 3, dtype=np.float32).reshape(8, 6, 3)
    p = str(tmp_path / "out.png")
    exr.write_png(p, img)
    np.testing.assert_array_equal(
        read_png(p), (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8))
