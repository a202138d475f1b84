"""Shared test utilities: oracle<->JAX feature comparison."""

from __future__ import annotations

import numpy as np


def features_to_numpy(feats):
    """Features pytree -> dict of numpy arrays for image b=0, masked rows only."""
    m = np.asarray(feats.mask[0])
    out = {}
    for name in ("x", "y", "sigma", "theta", "response", "octave"):
        out[name] = np.asarray(getattr(feats, name)[0])[m]
    out["desc"] = np.asarray(feats.desc[0])[m]
    return out


def greedy_match_keypoints(a, b, pos_tol=0.5, sigma_rtol=0.1):
    """Greedily pair keypoints of dicts a, b by (x, y) distance.

    Returns list of (ia, ib) index pairs where position within pos_tol and
    sigma within sigma_rtol relative.
    """
    used = set()
    pairs = []
    for ia in range(len(a["x"])):
        d2 = (b["x"] - a["x"][ia]) ** 2 + (b["y"] - a["y"][ia]) ** 2
        order = np.argsort(d2)
        for ib in order[:5]:
            if ib in used:
                continue
            if d2[ib] > pos_tol * pos_tol:
                break
            if abs(b["sigma"][ib] - a["sigma"][ia]) > sigma_rtol * a["sigma"][ia]:
                continue
            used.add(ib)
            pairs.append((ia, int(ib)))
            break
    return pairs


def angdiff(t0, t1):
    d = np.abs(t0 - t1) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def desc_cosine(d0, d1):
    a = d0.astype(np.float64)
    b = d1.astype(np.float64)
    na = np.linalg.norm(a)
    nb = np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(a @ b / (na * nb))
