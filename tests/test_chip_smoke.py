"""chip_smoke.py on the CPU: its device check, its set-up and its
comparison helpers (the GPU phases themselves run only on a card)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from siftgpu_tpu.core import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, timeout=300,
        capture_output=True, text=True,
    )


def test_device_check_exits_nonzero_without_gpu():
    p = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert p.returncode != 0
    assert "no GPU found" in p.stderr
    assert '"ok"' not in p.stdout


def test_script_alone_fails_without_output(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
    p = _run(str(script), str(tmp_path))
    assert p.returncode != 0
    assert p.stdout == ""


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU found"):
        runtime.require_gpu()


@pytest.mark.parametrize("given", [None, "/tmp/elsewhere/cache"])
def test_compile_cache_placement(given):
    env = {} if given is None else {"JAX_COMPILATION_CACHE_DIR": given}
    root = "/checkout"
    assert runtime.compile_cache_dir(root, environ=env) == (
        given or os.path.join(root, ".jax_cache"))
    # a subdirectory applies only where the directory is this repo's own
    assert runtime.compile_cache_dir(root, "cpu-abc", environ=env) == (
        given or os.path.join(root, ".jax_cache", "cpu-abc"))


def test_nearest_within_and_set_overlap():
    a = np.array([[0.0, 0.0], [10.0, 10.0], [20.0, 0.0]])
    b = np.array([[0.3, -0.2], [10.6, 10.0], [50.0, 50.0], [19.9, 0.1]])
    np.testing.assert_array_equal(cs.nearest_within(a, b, 0.5), [0, -1, 3])
    assert cs.set_overlap(a, b, 0.5) == pytest.approx(0.5)   # b side: 2/4
    assert cs.set_overlap(a, a, 0.0) == 1.0
    assert cs.set_overlap(a[:0], b[:0], 0.5) == 1.0
    assert cs.set_overlap(a, b[:0], 0.5) == 0.0
    # per-column tolerance
    np.testing.assert_array_equal(
        cs.nearest_within(a, b, (1.0, 0.1)), [-1, 1, 3])


def test_match_quads_and_inlier_rate():
    x0 = np.array([1.0, 2.0, 3.0])
    y0 = np.array([5.0, 6.0, 7.0])
    x1, y1 = x0 + 3.0, y0 - 2.0
    x1[2] += 4.0                                   # one outlier
    pairs = np.array([[0, 0], [1, 1], [2, 2], [-1, -1]])
    q = cs.match_quads(x0, y0, x1, y1, pairs, 3)
    assert q.shape == (3, 4)
    np.testing.assert_array_equal(q[1], [2.0, 6.0, 5.0, 4.0])
    assert cs.inlier_rate(q, (3.0, -2.0)) == pytest.approx(2 / 3)
    assert cs.inlier_rate(q[:0], (3.0, -2.0)) == 0.0


def test_descriptor_agreement():
    from collections import namedtuple

    F = namedtuple("F", "x y sigma theta mask desc octave")
    rng = np.random.default_rng(4)
    n = 2000
    kp = rng.uniform(1, 100, (4, n)).astype(np.float32)
    desc = rng.integers(10, 200, (n, 128)).astype(np.uint8)
    mask = np.ones(n, bool)
    oct_ = np.zeros(n, np.int32)
    fa = F(*[v[None] for v in kp], mask[None], desc[None], oct_[None])
    d2 = desc.copy()
    d2[:, 0] += 1                    # one step everywhere
    order = rng.permutation(n)       # the other run lists them differently
    fb = F(*[v[None, order] for v in kp], mask[None], d2[None, order],
           oct_[None])
    n_co, steps, cos, note = cs.descriptor_agreement(fa, fb, 0)
    assert (n_co, steps, note) == (n, 1, "")
    assert 0.999 < cos < 1.0
    assert cs._desc_ok(n_co, steps, n)
    d2[7, 3] += 3                    # one keypoint three steps off
    fb = fb._replace(desc=d2[None, order])
    n_co, steps, cos, note = cs.descriptor_agreement(fa, fb, 0)
    assert steps == 3 and "1 kp beyond 1 step" in note
    assert not cs._desc_ok(n_co, steps, n)
    # moving a keypoint by more than 1e-3 px takes it out of the comparison
    fb2 = fb._replace(x=fb.x + 0.01)
    assert cs.descriptor_agreement(fa, fb2, 0)[0] == 0


_STREAM = dict(stream_threshold=128, stream_block=128)


def test_matcher_best2_matches_reference_on_cpu():
    """The streaming best-2 stage (four 128-column blocks) against the exact
    brute force: best column identical, second similarity within 5e-7 and
    pointing at the exact second column alone."""
    from siftgpu_tpu import MatchConfig

    d0, d1 = cs._sixteen_k_sets(512, seed=2)
    cfg = MatchConfig(max_sift=512, max_match=512, **_STREAM)
    got_best, got_second = (np.asarray(v)[:64]
                            for v in cs.matcher_best2(d0, d1, cfg))
    best, sec, _, sc = cs.best2_reference(d0[:64], d1)
    np.testing.assert_array_equal(got_best, best)
    assert np.abs(got_second - sc).max() <= 5e-7
    np.testing.assert_array_equal(
        cs.second_columns(cs.cosines(d0[:64], d1), got_best, got_second,
                          5e-7), sec)
    with pytest.raises(ValueError, match="dense path"):
        cs.matcher_best2(d0, d1[:128], cfg)


def test_second_columns_marks_ties_and_misses():
    cos = np.array([[0.9, 0.5, 0.7, 0.1],
                    [0.9, 0.7, 0.7, 0.1],
                    [0.9, 0.5, 0.6, 0.1]])
    best = np.array([0, 0, 0])
    got = cs.second_columns(cos, best, [0.7, 0.7, 0.65], 1e-6)
    np.testing.assert_array_equal(got, [2, -1, -1])


def test_best2_reference_and_ratio_decision():
    rng = np.random.default_rng(0)
    d1 = rng.integers(0, 256, (300, 128), np.uint8)
    d0 = d1[[7, 42]].copy()
    d0[1] = np.clip(d0[1].astype(int) + 3, 0, 255)
    best, second, bc, sc = cs.best2_reference(d0, d1)
    np.testing.assert_array_equal(best, [7, 42])
    cos = (d0 @ d1.T.astype(np.float64)) / np.outer(
        np.linalg.norm(d0.astype(float), axis=1),
        np.linalg.norm(d1.astype(float), axis=1))
    for r in range(2):
        order = np.argsort(-cos[r], kind="stable")
        assert second[r] == order[1]
        assert sc[r] == pytest.approx(cos[r, order[1]])
    assert bc[0] == pytest.approx(1.0)
    np.testing.assert_array_equal(
        cs.ratio_decision(bc, sc, 0.7, 0.8), [True, True])
    # a near-tie best/second fails the ratio test
    assert not cs.ratio_decision(np.array([0.9]), np.array([0.899]), 0.7, 0.8)[0]


@pytest.mark.gpu
def test_u8_best2_on_the_gpu_matches_exact_reference(gpu_device):
    """On a card: the streaming matcher's best index and second similarity
    for uint8 descriptors agree with the exact integer brute force."""
    import jax

    from siftgpu_tpu import MatchConfig

    d0, d1 = cs._sixteen_k_sets(2048, seed=1)
    cfg = MatchConfig(max_sift=2048, max_match=2048, **_STREAM)
    got_best, got_second = (np.asarray(v)[:128] for v in cs.matcher_best2(
        jax.device_put(d0, gpu_device), jax.device_put(d1, gpu_device), cfg))
    best, sec, _, sc = cs.best2_reference(d0[:128], d1)
    np.testing.assert_array_equal(got_best, best)
    assert np.abs(got_second - sc).max() <= 5e-7
    np.testing.assert_array_equal(
        cs.second_columns(cs.cosines(d0[:128], d1), got_best, got_second,
                          5e-7), sec)
