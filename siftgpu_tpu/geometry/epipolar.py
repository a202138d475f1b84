"""Two-view epipolar geometry: 8-point essential/fundamental + RANSAC.

New capability vs the reference (SURVEY.md §7: the SfM back end the north star
adds on top of SiftGPU).  Fixed-shape RANSAC (SURVEY §7.4 item 6): a STATIC
number of hypotheses evaluated in parallel under `vmap` — no early exit, no
dynamic shapes; masked correspondences never contribute to scores.

Conventions: points are 2-D in NORMALIZED camera coordinates (K^-1 applied)
for the essential path; `eight_point` itself is metric-agnostic (also usable
for F).  E maps image0 -> image1: x1^T E x0 = 0.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["RansacResult", "eight_point", "sampson_distance", "ransac_essential"]


def _homog(x):
    return jnp.concatenate([x, jnp.ones_like(x[..., :1])], axis=-1)


def _normalize_for_dlt(x, w):
    """Hartley normalization (masked): center + sqrt(2) mean distance."""
    wsum = jnp.maximum(w.sum(), 1e-9)
    mean = (x * w[:, None]).sum(0) / wsum
    d = jnp.sqrt(((x - mean) ** 2).sum(-1))
    scale = jnp.sqrt(2.0) / jnp.maximum((d * w).sum() / wsum, 1e-9)
    T = jnp.array(
        [[1.0, 0.0, -mean[0]], [0.0, 1.0, -mean[1]], [0.0, 0.0, 1.0 / scale]]
    ) * scale
    T = T.at[2, 2].set(1.0)
    return (x - mean) * scale, T


def eight_point(x0: jax.Array, x1: jax.Array, w: jax.Array) -> jax.Array:
    """Weighted 8-point algorithm.  x0, x1: [N, 2]; w: [N] weights.

    Returns E (3x3) with the essential constraint (two equal singular values,
    third zero) enforced.  Uses Hartley normalization + smallest eigenvector
    of A^T A (9x9 eigh — fixed small shape, no [N, 9] SVD).
    """
    x0n, T0 = _normalize_for_dlt(x0, w)
    x1n, T1 = _normalize_for_dlt(x1, w)
    u0, v0 = x0n[:, 0], x0n[:, 1]
    u1, v1 = x1n[:, 0], x1n[:, 1]
    ones = jnp.ones_like(u0)
    A = jnp.stack(
        [u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0, ones], axis=1
    )                                                    # [N, 9]
    Aw = A * w[:, None]
    M = Aw.T @ A                                         # [9, 9]
    _, vecs = jnp.linalg.eigh(M)
    e = vecs[:, 0]                                       # smallest eigenvalue
    En = e.reshape(3, 3)
    E = T1.T @ En @ T0
    # enforce (1, 1, 0) singular values
    U, s, Vt = jnp.linalg.svd(E)
    sm = (s[0] + s[1]) / 2.0
    return U @ jnp.diag(jnp.array([sm, sm, 0.0])) @ Vt


def sampson_distance(E: jax.Array, x0: jax.Array, x1: jax.Array) -> jax.Array:
    """First-order geometric (Sampson) distance per correspondence. [N]."""
    h0 = _homog(x0)                                      # [N, 3]
    h1 = _homog(x1)
    Ex0 = h0 @ E.T                                       # [N, 3]
    Etx1 = h1 @ E
    num = jnp.sum(h1 * Ex0, axis=-1) ** 2
    den = Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Etx1[:, 0] ** 2 + Etx1[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


class RansacResult(NamedTuple):
    E: jax.Array         # [3, 3] refined essential matrix
    inliers: jax.Array   # [N] bool
    num_inliers: jax.Array
    best_score: jax.Array


@partial(jax.jit, static_argnums=(4, 6))
def ransac_essential(
    x0: jax.Array, x1: jax.Array, mask: jax.Array, key: jax.Array,
    num_hypotheses: int = 512, threshold: float = 1e-4, refine_iters: int = 2,
) -> RansacResult:
    """Fixed-iteration batched RANSAC for E.  x0, x1: [N, 2] normalized coords.

    `threshold` is on squared Sampson distance in normalized coordinates
    (~ (px_tol / focal)^2).  All `num_hypotheses` minimal sets are evaluated
    in parallel; invalid correspondences are sampled with probability ~0 and
    never counted in scores.
    """
    n = x0.shape[0]
    probs = mask.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1e-9)
    idx = jax.random.choice(key, n, shape=(num_hypotheses, 8), p=probs)

    ones8 = jnp.ones(8, jnp.float32)

    def hyp(i8):
        return eight_point(x0[i8], x1[i8], ones8)

    Es = jax.vmap(hyp)(idx)                              # [H, 3, 3]

    def score(E):
        d = sampson_distance(E, x0, x1)
        inl = (d < threshold) & mask
        return inl.sum(), inl

    scores, inls = jax.vmap(score)(Es)
    best = jnp.argmax(scores)
    E = Es[best]
    inliers = inls[best]

    # iterative weighted refinement on the full inlier set
    for _ in range(refine_iters):
        E = eight_point(x0, x1, inliers.astype(jnp.float32))
        d = sampson_distance(E, x0, x1)
        inliers = (d < threshold) & mask

    return RansacResult(
        E=E, inliers=inliers,
        num_inliers=inliers.sum().astype(jnp.int32),
        best_score=scores[best].astype(jnp.int32),
    )
