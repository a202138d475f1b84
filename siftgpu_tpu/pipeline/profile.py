"""Per-stage profiling harness (SURVEY.md §5.1: the `ClockTimer` / `-v 2..4`
per-stage ms table analog, built on `block_until_ready` timing and
`jax.named_scope`).

Each stage is jitted separately so stage boundaries are real device sync
points — the same protocol the reference used (`glFinish` before timers ⚠).
The composite pipeline remains one fused program in production; this harness
exists to attribute time, not to run fast.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp

from ..core.config import MatchConfig, SiftConfig
from ..frontend import describe, detect, match, orient, pyramid
from ..frontend.extract import assemble_features, to_image_coords

__all__ = ["profile_extraction", "format_stage_table"]


def profile_extraction(
    images: jax.Array, cfg: SiftConfig, iters: int = 20, match_pairs: bool = True,
    mcfg: MatchConfig | None = None,
) -> Dict[str, float]:
    """Returns {stage: seconds_per_iter} with stages pyramid / detect /
    orient / describe / assemble / match."""
    B = images.shape[0]
    mcfg = mcfg or MatchConfig(max_sift=cfg.max_keypoints, max_match=cfg.max_keypoints)

    pyr_fn = jax.jit(partial(pyramid.build_pyramid, cfg=cfg))

    @jax.jit
    def detect_fn(pyr):
        return detect.detect_pyramid(pyr, cfg)

    @jax.jit
    def grad_fn(pyr):
        return [orient.gradient_stack(oc.gauss, cfg) for oc in pyr]

    @jax.jit
    def orient_fn(grads, kps):
        return [
            orient.compute_orientations(g, kp, cfg) for g, kp in zip(grads, kps)
        ]

    @jax.jit
    def describe_fn(grads, kps, orients):
        outs = []
        n = cfg.max_orientations
        for g, kp, (theta, valid) in zip(grads, kps, orients):
            cap = kp.y.shape[1]

            def dup(a):
                return jnp.repeat(a[..., None], n, axis=-1).reshape(B, cap * n)

            outs.append(
                describe.compute_descriptors(
                    g, dup(kp.y), dup(kp.x), dup(kp.sigma),
                    theta.reshape(B, cap * n), dup(kp.grad_level), cfg,
                )
            )
        return outs

    @jax.jit
    def assemble_fn(kps, orients, descs):
        parts = []
        n = cfg.max_orientations
        for o, (kp, (theta, valid), d) in enumerate(zip(kps, orients, descs)):
            cap = kp.y.shape[1]

            def dup(a):
                return jnp.repeat(a[..., None], n, axis=-1).reshape(B, cap * n)

            cand = dict(
                y=dup(kp.y), x=dup(kp.x), sigma=dup(kp.sigma),
                theta=theta.reshape(B, cap * n), response=dup(kp.response),
                mask=valid.reshape(B, cap * n), desc=d,
            )
            parts.append(to_image_coords(cand, cfg, o, B))
        return assemble_features(parts, cfg)

    def timeit(fn, *args):
        out = jax.block_until_ready(fn(*args))   # compile + warm
        t0 = time.perf_counter()
        for _ in range(iters):
            jax.block_until_ready(fn(*args))
        return (time.perf_counter() - t0) / iters, out

    times: Dict[str, float] = {}
    times["pyramid"], pyr = timeit(pyr_fn, images)
    times["detect"], kps = timeit(detect_fn, pyr)
    times["gradients"], grads = timeit(grad_fn, pyr)

    times["orient"], orients = timeit(orient_fn, grads, kps)
    times["describe"], descs = timeit(describe_fn, grads, kps, orients)
    times["assemble"], feats = timeit(assemble_fn, kps, orients, descs)

    if match_pairs and B >= 2:
        def match_fn():
            return match.match_descriptors(
                feats.desc[0], feats.desc[1], feats.mask[0], feats.mask[1], mcfg
            )

        times["match"], _ = timeit(match_fn)

    times["TOTAL"] = sum(v for k, v in times.items() if k != "TOTAL")
    return times


def format_stage_table(times: Dict[str, float], batch: int = 1) -> str:
    lines = [f"{'stage':<10} {'ms/iter':>10} {'ms/frame':>10}"]
    for k, v in times.items():
        lines.append(f"{k:<10} {v * 1e3:>10.2f} {v * 1e3 / batch:>10.2f}")
    return "\n".join(lines)
