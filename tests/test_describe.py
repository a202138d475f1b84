"""Descriptor binning and the orientation window: the production binning
body against the golden one-hot body, and the window polynomial pinned to
its recorded output."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np

from siftgpu_tpu.core.config import SiftConfig
from siftgpu_tpu.frontend import describe, detect, orient, pyramid
from siftgpu_tpu.oracle import fixtures


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def _bin_chunk(sgx, sgy, theta, cfg: SiftConfig):
    """Golden (one-hot) binning body: raw pre-normalization descriptors.

    sgx, sgy: [B, C, G2] bilinear gradient samples on the rotated grid, with
    out-of-image samples already zeroed; theta: [B, C].  The reference that
    `describe._bin_chunk_fast` is tested against.
    """
    G = cfg.descriptor_grid
    D = cfg.descriptor_width
    NB = cfg.descriptor_bins
    B, C, G2 = sgx.shape
    two_pi = describe._TWO_PI

    _, wrc, gw = describe._grid_constants(G, D, cfg.descriptor_samples_per_cell)
    wrc = jnp.asarray(wrc)
    gwf = jnp.asarray(gw).reshape(G2)

    mag = jnp.sqrt(sgx * sgx + sgy * sgy) * gwf            # [B, C, G2]
    ang = (jnp.arctan2(sgy, sgx) - theta[..., None]) % two_pi
    ob = ang * (NB / two_pi)
    o0 = jnp.clip(jnp.floor(ob).astype(jnp.int32), 0, NB - 1)
    fo = ob - jnp.floor(ob)

    oh0 = jax.nn.one_hot(o0, NB, dtype=jnp.float32)
    oh1 = jax.nn.one_hot((o0 + 1) % NB, NB, dtype=jnp.float32)
    mo = (mag * (1.0 - fo))[..., None] * oh0 + (mag * fo)[..., None] * oh1
    mo = mo.reshape(B, C, G, G, NB)

    desc = jnp.einsum(
        "bkijo,ir,jc->bkrco", mo, wrc, wrc,
        precision=jax.lax.Precision.HIGHEST,
    )                                                      # [B, C, D, D, NB]
    return desc.reshape(B, C, D * D * NB)


def test_bin_chunk_fast_matches_golden_body():
    """`_bin_chunk_fast` (circular-tent + single [G2, D*D] contraction, the
    production binning) computes the SAME adjacent-bin soft-assign weights
    as the golden one-hot `_bin_chunk` above; only the contraction association
    differs (one collapsed [G2, 16] matmul vs two [16, 4] einsums), so the
    uint8-quantized descriptors agree to at most one quantization step."""
    cfg = SiftConfig(height=64, width=96)
    G2 = cfg.descriptor_grid ** 2
    rng = np.random.default_rng(7)
    B, C = 2, 256
    sgx = jnp.asarray(rng.standard_normal((B, C, G2)).astype(np.float32))
    sgy = jnp.asarray(rng.standard_normal((B, C, G2)).astype(np.float32))
    th = jnp.asarray(rng.uniform(0, 2 * np.pi, (B, C)).astype(np.float32))

    ref = np.asarray(_bin_chunk(sgx, sgy, th, cfg))
    fast = np.asarray(describe._bin_chunk_fast(sgx, sgy, th, cfg))
    # raw pre-normalization values agree to f32 summation-order tolerance
    np.testing.assert_allclose(fast, ref, rtol=2e-5, atol=2e-5)

    q_ref = np.asarray(
        describe.finalize_descriptors(jnp.asarray(ref), cfg)).astype(int)
    q = np.asarray(describe.finalize_descriptors(
        jnp.asarray(fast), cfg)).astype(int)
    d = np.abs(q - q_ref)
    assert d.max() <= 1, f"max step {d.max()}"
    assert (d > 0).mean() < 1e-3


def test_compute_descriptors_stays_within_a_step_of_golden(monkeypatch):
    """The shipped body and chunking of `compute_descriptors` against the
    golden one-hot body on real keypoints: at most one uint8 step, for the
    default chunk and for a chunk that pads the last step."""
    cfg = SiftConfig(height=96, width=128, max_keypoints=128)
    img = fixtures.random_texture(96, 128, seed=3, smooth=3)
    oc = pyramid.build_pyramid(jnp.asarray(img[None]), cfg)[0]
    kp = detect.detect_octave(oc, cfg, 64)
    grads = orient.gradient_stack(oc.gauss, cfg)
    theta, _ = orient.compute_orientations(grads, kp, cfg)
    th = theta[..., 0]

    def run(chunk=None):
        return np.asarray(describe.compute_descriptors(
            grads, kp.y, kp.x, kp.sigma, th, kp.grad_level, cfg,
            chunk=chunk)).astype(int)

    shipped, padded = run(), run(chunk=24)
    monkeypatch.setattr(describe, "_bin_chunk_fast", _bin_chunk)
    golden = run()
    m = np.asarray(kp.mask[0])
    assert m.sum() > 20
    assert np.abs(shipped[0][m] - golden[0][m]).max() <= 1
    np.testing.assert_array_equal(padded, shipped)


def test_exp_window_is_bit_identical_to_before_the_move():
    """`exp_window` moved into frontend/orient.py unchanged: its jitted
    output on a seeded input hashes to the value the pre-move function
    produced on XLA:CPU."""
    rng = np.random.default_rng(2024)
    x = jnp.asarray(rng.uniform(-6.0, 0.5, 4096).astype(np.float32))
    assert _digest([jax.jit(orient.exp_window)(x)]) == "f8424cbe5a93060c"
