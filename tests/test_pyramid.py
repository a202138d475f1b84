import jax.numpy as jnp
import numpy as np

from siftgpu_tpu.core.config import SiftConfig
from siftgpu_tpu.frontend import pyramid
from siftgpu_tpu.oracle import fixtures, sift_cpu


def test_pyramid_matches_oracle():
    cfg = SiftConfig(height=64, width=80)
    img = fixtures.random_texture(64, 80, seed=7)
    opyr = sift_cpu.build_pyramid(img, cfg)
    jpyr = pyramid.build_pyramid(jnp.asarray(img[None]), cfg)
    assert len(jpyr) == cfg.octaves == len(opyr)
    for o in range(cfg.octaves):
        g = np.asarray(jpyr[o].gauss[0])
        d = np.asarray(jpyr[o].dog[0])
        assert g.shape == opyr[o]["gauss"].shape
        np.testing.assert_allclose(g, opyr[o]["gauss"], atol=2e-6)
        np.testing.assert_allclose(d, opyr[o]["dog"], atol=4e-6)


def test_pyramid_upsampled_first_octave():
    cfg = SiftConfig(height=32, width=40, first_octave=-1, min_octave_dim=16)
    img = fixtures.random_texture(32, 40, seed=9)
    opyr = sift_cpu.build_pyramid(img, cfg)
    jpyr = pyramid.build_pyramid(jnp.asarray(img[None]), cfg)
    assert jpyr[0].gauss.shape[-2:] == (64, 80)
    np.testing.assert_allclose(
        np.asarray(jpyr[0].gauss[0]), opyr[0]["gauss"], atol=2e-6
    )


def test_batch_axis_independent():
    cfg = SiftConfig(height=32, width=32, num_octaves=2)
    a = fixtures.random_texture(32, 32, seed=1)
    b = fixtures.random_texture(32, 32, seed=2)
    both = pyramid.build_pyramid(jnp.stack([jnp.asarray(a), jnp.asarray(b)]), cfg)
    solo = pyramid.build_pyramid(jnp.asarray(b[None]), cfg)
    np.testing.assert_allclose(
        np.asarray(both[1].gauss[1]), np.asarray(solo[1].gauss[0]), atol=1e-6
    )


def test_matmul_blur_matches_conv():
    """The banded-matmul blur (full band below 512 px, blocked above)
    equals a float64 NumPy separable convolution with replicate padding."""
    from siftgpu_tpu.core import scalespace

    rng = np.random.default_rng(11)
    for H, W in [(70, 90), (530, 140), (60, 700)]:
        img = rng.random((1, H, W)).astype(np.float32)
        for sigma in (1.1, 2.5, 3.2):
            taps = scalespace.gaussian_taps(sigma)
            r = (len(taps) - 1) // 2
            ref = img.astype(np.float64)
            for axis in (2, 1):
                pad = [(0, 0)] * 3
                pad[axis] = (r, r)
                p = np.pad(ref, pad, mode="edge")
                n = ref.shape[axis]
                ref = sum(
                    t * np.take(p, np.arange(k, k + n), axis=axis)
                    for k, t in enumerate(taps)
                )
            got = pyramid.blur_separable(jnp.asarray(img), taps)
            np.testing.assert_allclose(np.asarray(got), ref, atol=2e-6)


def test_decimation_matmul_matches_window_and_slice():
    """The stride-2 window decimation is bit-identical to x[::2, ::2],
    including odd sizes."""
    rng = np.random.default_rng(3)
    for H, W in [(64, 96), (57, 131), (600, 777)]:
        x = jnp.asarray(rng.normal(size=(2, H, W)).astype(np.float32))
        c = np.asarray(x)[:, ::2, ::2]
        assert np.array_equal(np.asarray(pyramid.downsample2x(x)), c)
