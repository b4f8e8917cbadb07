"""Process set-up shared by the measuring entry points (``bench.py``,
``chip_smoke.py``): the persistent compile cache and the device record
every result is printed with.
"""

from __future__ import annotations

import os
import subprocess

#: root of the checkout this package runs from
REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

#: compile cache used when ``JAX_COMPILATION_CACHE_DIR`` is unset — a fixed
#: path (the path is part of the cache key), listed in ``.gitignore``
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def configure_compile_cache():
    """Enable JAX's persistent compile cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it by itself and
    nothing is overridden; otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def nvidia_smi_line():
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (one line per card), or ``None`` where the tool is missing."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def require_gpu():
    """The JAX devices, if they are GPUs; ``SystemExit`` otherwise — a
    measurement never falls back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found {devices[0].platform} devices only")
    return devices


def device_record(devices):
    """``{"platform", "kind", "count"}`` of the devices as JAX reports
    them."""
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}
