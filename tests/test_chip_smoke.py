"""chip_smoke.py off the card: it must refuse to run without a GPU or
outside the repository, print the contract's last line, and select its
phases by option. The four-card check itself runs here on 4 virtual CPU
devices."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def assert_no_result(r):
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_exits_nonzero_without_gpu():
    r = run_script(REPO, "chip_smoke.py")
    assert_no_result(r)
    assert "no GPU" in r.stdout


def test_exits_nonzero_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = run_script(tmp_path, "chip_smoke.py")
    assert_no_result(r)
    assert "root of the repository" in r.stdout


def _fake_phases(monkeypatch, ran):
    def phase(name):
        def fn(*_):
            ran.append(name)
            return True
        return fn

    monkeypatch.setattr(chip_smoke, "phase_device", jax.devices)
    for name in ("kernel", "main", "four_cards"):
        monkeypatch.setattr(chip_smoke, f"phase_{name}", phase(name))


@pytest.mark.parametrize("argv,phases", [
    ([], ["kernel", "main"]),
    (["--four-cards"], ["four_cards"]),
])
def test_phase_selection_and_last_line(monkeypatch, capsys, argv, phases):
    ran = []
    _fake_phases(monkeypatch, ran)
    assert chip_smoke.main(argv) == 0
    assert ran == phases
    last = capsys.readouterr().out.strip().splitlines()[-1]
    devices = jax.devices()
    assert json.loads(last) == {"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}
    assert last.startswith('{"ok": true, "device": {"platform": ')


def test_failed_phase_prints_no_result(monkeypatch, capsys):
    ran = []
    _fake_phases(monkeypatch, ran)
    monkeypatch.setattr(chip_smoke, "phase_kernel",
                        lambda: 1 / 0)  # raises inside the phase
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out
    assert "ZeroDivisionError" in out and '"ok"' not in out
    assert ran == ["main"]  # the other phases still run


def test_four_cards_check_on_virtual_devices():
    """The sharded-vs-card-0 comparison of --four-cards, on 4 virtual CPU
    devices at a small size (fused fitter in the interpreter)."""
    from bmfr_tpu.config import bench_config

    cfg = bench_config(64, 48, pallas_interpret=True)
    assert chip_smoke.four_cards_check(cfg, jax.devices()[:4], frames=3)
