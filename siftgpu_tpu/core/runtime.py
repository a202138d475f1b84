"""Process set-up shared by the entry scripts (bench.py, chip_smoke.py, the
test suite): where the persistent compile cache lives, which device JAX
found, and which card it is.

Nothing here picks an implementation: every platform runs the same code.
"""

from __future__ import annotations

import os
import subprocess
from typing import Mapping, Optional

__all__ = [
    "compile_cache_dir", "configure_compile_cache", "require_gpu",
    "device_record", "gpu_board",
]


def compile_cache_dir(
    repo_root: str, subdir: Optional[str] = None,
    environ: Mapping[str, str] = os.environ,
) -> str:
    """`JAX_COMPILATION_CACHE_DIR` as given when it is set; otherwise the
    fixed `.jax_cache/` inside the checkout (optionally one `subdir` below
    it).  A fixed path matters: the path is part of the cache's key."""
    given = environ.get("JAX_COMPILATION_CACHE_DIR")
    if given:
        return given
    root = os.path.join(repo_root, ".jax_cache")
    return os.path.join(root, subdir) if subdir else root


def configure_compile_cache(
    repo_root: str, subdir: Optional[str] = None,
    min_compile_secs: float = 1.0,
) -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir`."""
    import jax

    path = compile_cache_dir(repo_root, subdir)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    return path


def require_gpu():
    """JAX's devices, or SystemExit (non-zero) when the first is no GPU:
    a measurement that finds no card fails instead of running on the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX reports platform {devs[0].platform!r} "
            f"({devs})"
        )
    return devs


def device_record() -> dict:
    """{"platform", "kind", "count"} of JAX's default devices."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def gpu_board() -> str:
    """The cards' names and power limits as `nvidia-smi` reports them, read
    by a child process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
