import jax.numpy as jnp
import numpy as np
import pytest

from siftgpu_tpu.core.config import SiftConfig
from siftgpu_tpu.frontend import detect, pyramid
from siftgpu_tpu.oracle import fixtures, sift_cpu


def _detect_sets(img, cfg):
    opyr = sift_cpu.build_pyramid(img, cfg)
    okps = sift_cpu.detect_keypoints(opyr, cfg)
    jpyr = pyramid.build_pyramid(jnp.asarray(img[None]), cfg)
    jkps = []
    for o in range(cfg.octaves):
        kp = detect.detect_octave(jpyr[o], cfg, cfg.octave_cap(o))
        m = np.asarray(kp.mask[0])
        for i in np.nonzero(m)[0]:
            jkps.append(
                dict(
                    octave=o,
                    y=float(kp.y[0, i]), x=float(kp.x[0, i]),
                    sigma=float(kp.sigma[0, i]),
                    response=float(kp.response[0, i]),
                )
            )
    return okps, jkps


def test_detection_matches_oracle():
    cfg = SiftConfig(height=64, width=80, max_keypoints=512)
    img = fixtures.random_texture(64, 80, seed=5)
    okps, jkps = _detect_sets(img, cfg)
    assert len(okps) == len(jkps) > 5
    for ok in okps:
        cand = [
            j for j in jkps
            if j["octave"] == ok["octave"]
            and (j["x"] - ok["x"]) ** 2 + (j["y"] - ok["y"]) ** 2 < 0.01
        ]
        assert cand, f"oracle keypoint not found: {ok}"
        j = cand[0]
        assert abs(j["sigma"] - ok["sigma"]) < 0.02 * ok["sigma"]
        assert abs(j["response"] - ok["response"]) < 1e-4


def test_blob_detected_at_known_location():
    """Analytic fixture: an isolated Gaussian blob must yield a keypoint at its
    center with scale ~ the blob sigma (SURVEY §4: stronger than the reference's
    eyeball testing)."""
    cfg = SiftConfig(height=64, width=64, max_keypoints=64)
    img = fixtures.gaussian_blob_image(64, 64, [(31.0, 35.0, 3.0, 1.0)])
    okps, jkps = _detect_sets(img, cfg)
    assert jkps, "blob not detected"
    best = min(jkps, key=lambda k: (k["x"] - 35) ** 2 + (k["y"] - 31) ** 2)
    scale = cfg.octave_scale(best["octave"])
    assert abs(best["x"] * scale - 35.0) < 0.75
    assert abs(best["y"] * scale - 31.0) < 0.75
    assert 1.5 < best["sigma"] * scale < 6.0


def test_no_keypoints_on_flat_image():
    cfg = SiftConfig(height=48, width=48, max_keypoints=64)
    img = np.full((48, 48), 0.5, np.float32)
    _, jkps = _detect_sets(img, cfg)
    assert jkps == []


def test_adjacent_max_min_both_survive_pooling():
    """A strict 26-neighbor MAXIMUM and MINIMUM can be 8-adjacent (same 2x2
    block); the pooled top-k must keep both (regression for the review
    finding that joint |DoG| pooling dropped one)."""
    from siftgpu_tpu.frontend.pyramid import Octave

    cfg = SiftConfig(
        height=32, width=32, num_octaves=1, max_keypoints=64,
        subpixel=False, border=1,
    )
    S = cfg.dog_levels
    dog = np.zeros((1, S + 2, 32, 32), np.float32)

    def bump(l, y, x, amp):
        dog[0, l, y - 1 : y + 2, x - 1 : x + 2] += amp * 0.3
        dog[0, l, y, x] += amp * 0.7

    bump(2, 10, 10, +0.05)
    bump(2, 10, 11, -0.05)
    bump(2, 20, 20, +0.05)
    oc = Octave(gauss=jnp.zeros((1, S + 3, 32, 32)), dog=jnp.asarray(dog))
    kp = detect.detect_octave(oc, cfg, 64)
    m = np.asarray(kp.mask[0])
    got = set(zip(np.asarray(kp.y[0])[m].astype(int), np.asarray(kp.x[0])[m].astype(int)))
    assert {(10, 10), (10, 11), (20, 20)} <= got


@pytest.mark.parametrize("subpixel,digest", [
    (True, "77428dcc074c51eb"), (False, "ddefeb9be6b6f40a"),
])
def test_cramer_record_is_bit_identical_to_before_the_move(subpixel, digest):
    """`cramer_record` moved into frontend/detect.py unchanged: its jitted
    record planes on a seeded DoG volume hash to the values the pre-move
    function produced on XLA:CPU."""
    import hashlib

    import jax

    rng = np.random.default_rng(2024)
    rng.uniform(-6.0, 0.5, 4096)     # same stream as the recorded run
    dog = jnp.asarray(rng.normal(0.0, 0.02, (2, 5, 24, 40)).astype(np.float32))

    def rec(d):
        S, H, W = d.shape[1] - 2, d.shape[2], d.shape[3]
        dgp = jnp.pad(d, ((0, 0), (0, 0), (1, 1), (1, 1)))

        def q(dl, dy, dx):
            return dgp[:, 1 + dl:1 + dl + S, 1 + dy:1 + dy + H,
                       1 + dx:1 + dx + W]

        v, ol, oy, ox, (a, b, c) = detect.cramer_record(q, subpixel)
        return v, ol, oy, ox, a, b, c

    h = hashlib.sha256()
    for arr in jax.jit(rec)(dog):
        h.update(np.ascontiguousarray(np.asarray(arr)).tobytes())
    assert h.hexdigest()[:16] == digest
