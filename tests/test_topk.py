"""Exact candidate top-k: one policy on every platform.

`detect._run_topk` selects the exact top-k of each pooled-score row (score
descending, index ascending on ties) with one `lax.top_k`, and pads tiny
octaves to the fixed capacity; the detector's winners and the per-octave
calls of `detect_pyramid` follow from it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from siftgpu_tpu import SiftConfig
from siftgpu_tpu.frontend import detect, pyramid
from siftgpu_tpu.oracle import fixtures


def _scores(rows, n, seed, ties=True):
    rng = np.random.default_rng(seed)
    s = rng.random((rows, n)).astype(np.float32)
    s[rng.random((rows, n)) < 0.7] = 0.0          # sparse, like pooled scores
    if ties:   # repeated values across chunk boundaries
        s[:, ::97] = 0.5
    return jnp.asarray(s)


def test_topk_matches_numpy_stable_sort():
    b = _scores(2, 4099, seed=9)
    k = 300
    v, i = detect._run_topk(b, k)
    a = np.asarray(b)
    for r in range(2):
        order = np.argsort(-a[r], kind="stable")[:k]
        np.testing.assert_array_equal(np.asarray(i[r]), order)
        np.testing.assert_array_equal(np.asarray(v[r]), a[r][order])


def test_run_topk_pads_tiny_rows_to_capacity():
    b = _scores(2, 40, seed=1, ties=False)
    top, idx = detect._run_topk(b, 64)
    assert top.shape == idx.shape == (2, 64)
    assert np.all(np.asarray(top)[:, 40:] == 0.0)
    np.testing.assert_array_equal(
        np.asarray(top)[:, :40], -np.sort(-np.asarray(b), axis=1))


@pytest.mark.parametrize("ties", [False, True])
def test_run_topk_is_deterministic_on_ties(ties):
    """Equal scores resolve to the lower flat index, so the winners do not
    depend on the platform's sort."""
    b = _scores(1, 3001, seed=5, ties=ties)
    v, i = detect._run_topk(b, 200)
    vv, ii = np.asarray(v[0]), np.asarray(i[0])
    same = vv[1:] == vv[:-1]
    assert np.all(ii[1:][same] > ii[:-1][same])
    assert np.all(vv[1:] <= vv[:-1])


def test_pyramid_winners_match_per_octave_detection():
    """`detect_pyramid` (per-octave top-k + one merged record gather) gives
    the same keypoints as `detect_octave` on each octave, with a binding
    cap at octave 0 (refined fields to f32 ulps: the two programs fuse
    the subpixel solve differently)."""
    img = fixtures.random_texture(160, 224, seed=8, smooth=3)
    cfg = SiftConfig(height=160, width=224, max_keypoints=128)
    pyr = pyramid.build_pyramid(jnp.asarray(img[None]), cfg)
    kps = jax.jit(lambda p: detect.detect_pyramid(p, cfg))(pyr)
    assert int(np.asarray(kps[0].mask).sum()) > 0
    for o, (oc, kp) in enumerate(zip(pyr, kps)):
        ref = detect.detect_octave(oc, cfg, cfg.octave_cap(o))
        np.testing.assert_array_equal(np.asarray(ref.mask), np.asarray(kp.mask))
        for a, b in zip(ref, kp):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)
