"""External cross-check vs OpenCV SIFT (VERDICT r1 weak #2).

Parity elsewhere in the suite is proven against the in-repo NumPy oracle,
which shares conventions (and could share bugs) with the JAX path.  OpenCV's
SIFT is an independent third implementation of Lowe's algorithm: agreeing
with it pins our constants/conventions externally, the BASELINE's
"repeatability vs reference SiftGPU >= 95%" row measured against a real
foreign implementation rather than ourselves.

Convention mapping discovered and codified here:
  - cv2 KeyPoint.size is the DIAMETER: size == 2 * our sigma;
  - cv2 angle is degrees in the same rotational sense as our theta;
  - descriptor cells are ordered identically; the 8 angular bins run in the
    OPPOSITE direction offset by one: cv2_bin = (1 - our_bin) mod 8.
    (Every public SIFT differs in such conventions — VLFeat vs OpenCV too;
    the *content* is what the cosine checks.)
OpenCV applies its contrast threshold as |DoG| >= contrastThreshold / S on
0..1 images, so contrastThreshold=0.04 pairs with dog_threshold=0.04/3, and
always upsamples (first_octave=-1).
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from siftgpu_tpu import SiftConfig, extract_features_jit  # noqa: E402
from siftgpu_tpu.oracle import fixtures  # noqa: E402


def _extract_both(seed, H=200, W=240):
    img = fixtures.random_texture(H, W, seed=seed, smooth=3)
    img8 = np.clip(img * 255, 0, 255).astype(np.uint8)
    sift = cv2.SIFT_create(
        nfeatures=0, nOctaveLayers=3, contrastThreshold=0.04,
        edgeThreshold=10, sigma=1.6,
    )
    kps, cdesc = sift.detectAndCompute(img8, None)
    cv = dict(
        x=np.array([k.pt[0] for k in kps]),
        y=np.array([k.pt[1] for k in kps]),
        sigma=np.array([k.size for k in kps]) / 2.0,
        theta=np.deg2rad(np.array([k.angle for k in kps])),
        desc=np.asarray(cdesc, np.float32),
    )
    cfg = SiftConfig(height=H, width=W, max_keypoints=2048, first_octave=-1,
                     dog_threshold=0.04 / 3)
    f = extract_features_jit(jnp.asarray(img[None]), cfg)
    m = np.asarray(f.mask[0])
    ours = dict(
        x=np.asarray(f.x[0])[m], y=np.asarray(f.y[0])[m],
        sigma=np.asarray(f.sigma[0])[m], theta=np.asarray(f.theta[0])[m],
        desc=np.asarray(f.desc[0])[m].astype(np.float32),
    )
    return cv, ours


def _pairable(cv, ours, px=1.5, log2_scale=0.5):
    d2 = (cv["x"][:, None] - ours["x"][None]) ** 2 + \
         (cv["y"][:, None] - ours["y"][None]) ** 2
    sc = np.abs(np.log2(cv["sigma"][:, None] / ours["sigma"][None]))
    return (d2 < px * px) & (sc < log2_scale)


def test_keypoint_repeatability_vs_opencv():
    """>= 95% of OpenCV's keypoints have one of ours at the same place+scale
    and vice versa (BASELINE.md repeatability row, externally measured)."""
    for seed in (11, 23):
        cv, ours = _extract_both(seed)
        P = _pairable(cv, ours)
        cv_cov = P.any(1).mean()
        our_cov = P.any(0).mean()
        assert cv_cov >= 0.95, f"seed {seed}: only {cv_cov:.1%} of cv2 kps found"
        assert our_cov >= 0.90, f"seed {seed}: only {our_cov:.1%} of ours in cv2"


def test_orientation_and_descriptor_vs_opencv():
    """At spatially-paired keypoints with agreeing orientation, descriptors
    match OpenCV's at >= 0.95 median cosine after the bin-direction remap."""
    cv, ours = _extract_both(11)
    P = _pairable(cv, ours, px=1.0, log2_scale=0.3)
    ci, oi = np.nonzero(P)
    dth = (ours["theta"][oi] - cv["theta"][ci]) % (2 * np.pi)
    dth = np.minimum(dth, 2 * np.pi - dth)
    # same angular convention: most pairs agree (the remainder are distinct
    # secondary-orientation peaks, which both sides emit independently)
    assert (dth < 0.2).mean() > 0.5, f"orientation agreement {(dth<0.2).mean():.1%}"

    sel = dth < 0.1
    A = ours["desc"][oi[sel]].reshape(-1, 4, 4, 8)
    A = np.roll(A[..., ::-1], 1, axis=-1).reshape(len(A), 128)  # bin remap
    B = cv["desc"][ci[sel]]
    A /= np.linalg.norm(A, axis=1, keepdims=True) + 1e-9
    B /= np.linalg.norm(B, axis=1, keepdims=True) + 1e-9
    cos = (A * B).sum(1)
    assert len(cos) >= 30
    assert np.median(cos) >= 0.95, f"median desc cosine {np.median(cos):.3f}"
    assert cos.mean() >= 0.90, f"mean desc cosine {cos.mean():.3f}"
