"""On-card smoke test: ``chip_smoke.py`` on the GPU, in a subprocess.

The pytest process stays on the CPU (conftest), so the card is taken only
by the child. Whether a card is present is decided inside the fixture,
never at import. Run on a GPU machine with:

    python -m pytest tests/test_gpu_smoke.py -m gpu
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu():
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no NVIDIA GPU: nvidia-smi not found")
    r = subprocess.run([smi, "-L"], capture_output=True, text=True,
                       timeout=60)
    if r.returncode != 0 or "GPU" not in r.stdout:
        pytest.skip("no NVIDIA GPU listed by nvidia-smi")


@pytest.mark.gpu
def test_chip_smoke_passes_on_the_card(gpu):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True
    assert last["device"]["platform"] == "gpu"
    assert last["device"]["count"] >= 1
