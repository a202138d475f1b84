"""One code path on every platform: what runs is chosen by shapes and
configuration, never by the backend.

Each layer is traced with `jax.default_backend` reporting "cpu", "gpu" and
"rocm" in turn; a layer that consulted the platform would trace a different
program.  The CPU tests therefore exercise exactly the program the card runs.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from siftgpu_tpu.core.config import MatchConfig, SiftConfig
from siftgpu_tpu.frontend import describe, detect, match, orient, pyramid
from siftgpu_tpu.oracle import fixtures

_CFG = SiftConfig(height=48, width=64, max_keypoints=64, num_octaves=2)


def _image():
    return jnp.asarray(fixtures.random_texture(48, 64, seed=1)[None])


def _pyr():
    return pyramid.build_pyramid(_image(), _CFG)


def _kp_and_grads():
    pyr = _pyr()
    kp = detect.detect_octave(pyr[0], _CFG, 32)
    return kp, orient.gradient_stack(pyr[0].gauss, _CFG)


def _u8(n, seed):
    return jnp.asarray(
        np.random.default_rng(seed).integers(0, 256, (n, 128), np.uint8))


def _layer_pyramid():
    return jax.make_jaxpr(lambda x: pyramid.build_pyramid(x, _CFG))(_image())


def _layer_scores():
    dog = _pyr()[0].dog
    return jax.make_jaxpr(lambda d: detect._octave_scores(d, _CFG)[0])(dog)


def _layer_topk():
    row = jnp.zeros((1, 4096), jnp.float32)
    return jax.make_jaxpr(lambda b: detect._run_topk(b, 64))(row)


def _layer_gradients():
    g = _pyr()[0].gauss
    return jax.make_jaxpr(lambda x: orient.gradient_stack(x, _CFG).gx)(g)


def _layer_orientation():
    kp, grads = _kp_and_grads()
    return jax.make_jaxpr(
        lambda k, g: orient.compute_orientations(g, k, _CFG))(kp, grads)


def _layer_binning():
    kp, grads = _kp_and_grads()
    th = jnp.zeros_like(kp.y)
    return jax.make_jaxpr(lambda k, g, t: describe.compute_descriptors(
        g, k.y, k.x, k.sigma, t, k.grad_level, _CFG))(kp, grads, th)


def _layer_match():
    cfg = MatchConfig(max_sift=256, max_match=256)
    return jax.make_jaxpr(
        lambda a, b: match.match_descriptors_impl(a, b, cfg=cfg)
    )(_u8(256, 0), _u8(256, 1))


def _layer_guided_match():
    cfg = MatchConfig(max_sift=256, max_match=256)
    loc = jnp.zeros((256, 2), jnp.float32)
    H = jnp.eye(3, dtype=jnp.float32)
    return jax.make_jaxpr(
        lambda a, b, la, lb, h: match.guided_match_descriptors(
            a, b, la, lb, H=h, F=h, cfg=cfg)
    )(_u8(256, 0), _u8(256, 1), loc, loc, H)


@pytest.mark.parametrize("layer", [
    _layer_pyramid, _layer_scores, _layer_topk, _layer_gradients,
    _layer_orientation, _layer_binning, _layer_match, _layer_guided_match,
], ids=["pyramid", "scores", "topk", "gradients", "orientation", "binning",
        "match", "guided_match"])
def test_layer_is_the_same_on_every_platform(layer, monkeypatch):
    traced = {}
    for platform in ("cpu", "gpu", "rocm"):
        monkeypatch.setattr(jax, "default_backend", lambda p=platform: p)
        traced[platform] = str(layer())
    assert traced["gpu"] == traced["cpu"]
    assert traced["rocm"] == traced["cpu"]


def test_no_module_asks_for_the_platform():
    """The package never branches on the backend or a device's platform."""
    root = pathlib.Path(__file__).resolve().parents[1] / "siftgpu_tpu"
    hits = [
        f"{p.relative_to(root)}:{i}"
        for p in sorted(root.rglob("*.py"))
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if "default_backend" in line or ".platform ==" in line
        or ".platform !=" in line
    ]
    # runtime.require_gpu is the one check, and it chooses no implementation
    assert [h.split(":")[0] for h in hits] == ["core/runtime.py"], hits
