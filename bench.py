#!/usr/bin/env python
"""Benchmark harness (the `speed.cpp` analog, SURVEY.md §3.5 ⚠).

Prints ONE JSON line:
  {"metric": "keypoints+matches/s per chip", "value": N, "unit": "items/s",
   "vs_baseline": R}

Protocol (BASELINE.md): steady state after jit warm-up; every timed call
ends in `jax.block_until_ready`; per-stage breakdown on stderr.  Workload =
BASELINE configs 1-3: extraction on a batch of 640x480 frames related by
known warps plus brute-force matching of consecutive pairs (real
correspondences, so the matcher's output is nontrivial), 1080p and 4K
extraction, and a 16k x 16k uint8 match.  The JSON line names the device
(platform, device_kind, device count) and the card (nvidia-smi name and
power limit).  A run that finds no GPU fails; it never falls back to the
CPU.

`vs_baseline`: BASELINE.json records no published reference numbers
("published": {}, mount empty — SURVEY §6).  We normalize against the
documented order-of-magnitude folklore for the reference on a 2007-era GPU
(~30 Hz * ~1k keypoints at 640x480 + ~4k-descriptor matching in tens of ms
 => ~6e4 items/s), i.e. vs_baseline = value / 60000.0.  Treat it as a
round-over-round trend indicator, not a calibrated comparison.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def _timed(fn, n: int, reps: int):
    """Per-call seconds of `fn()` for each of `reps` runs of n calls, each
    call ending in block_until_ready; returns (list, last output)."""
    import jax

    out, times = None, []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            out = jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) / n)
    return times, out


def main() -> None:
    import os

    from siftgpu_tpu.core import runtime

    runtime.configure_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    import jax
    import jax.numpy as jnp

    from siftgpu_tpu import MatchConfig, SiftConfig, extract_features_jit
    from siftgpu_tpu.frontend.match import match_descriptors, match_descriptors_batch
    from siftgpu_tpu.oracle import fixtures

    devs = runtime.require_gpu()
    card = runtime.gpu_board()
    print(f"device: {devs[0]} ({devs[0].device_kind}); card: {card}",
          file=sys.stderr)

    B, H, W = 4, 480, 640
    K = 2048
    cfg = SiftConfig(height=H, width=W, max_keypoints=K)
    mcfg = MatchConfig(max_sift=K, max_match=K)

    base = fixtures.random_texture(H, W, seed=0, smooth=3)
    frames = [base]
    for i in range(1, B):   # consecutive frames: known shifts -> real matches
        frames.append(
            fixtures.warp_affine(base, np.eye(2), np.array([3.0 * i, -2.0 * i]))
        )
    images = jax.device_put(jnp.asarray(np.stack(frames)))

    def extract():
        return extract_features_jit(images, cfg)

    # all B-1 consecutive pairs in ONE dispatch (vmapped matcher), with the
    # consecutive-pair slicing inside the jit
    _match_sliced = jax.jit(
        lambda desc, mask: match_descriptors_batch(
            desc[:-1], desc[1:], mask[:-1], mask[1:], mcfg
        )
    )

    def match_pairs(feats):
        return _match_sliced(feats.desc, feats.mask)

    # warm-up (compile)
    t0 = time.perf_counter()
    feats = jax.block_until_ready(extract())
    jax.block_until_ready(match_pairs(feats))
    print(f"warm-up (incl. compile): {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # steady state: REPS runs of `iters` calls each; the min over runs is
    # reported beside every run
    iters, REPS = 40, 5
    reps_ex, feats = _timed(extract, iters, REPS)
    reps_match, rs = _timed(lambda: match_pairs(feats), iters, REPS)
    t_ex = min(reps_ex)
    t_match = min(reps_match)
    kp_total = int(np.asarray(feats.count).sum()) * iters
    match_total = int(np.asarray(rs.count).sum()) * iters

    elapsed = (t_ex + t_match) * iters
    value = (kp_total + match_total) / elapsed
    fps = iters * B / elapsed
    print(
        f"640x480: extract {t_ex * 1e3:.1f} ms/iter ({B} frames), "
        f"match {t_match * 1e3:.1f} ms/iter ({B - 1} pairs), "
        f"{fps:.1f} frames/s, {kp_total // iters} kp/iter, "
        f"{match_total // iters} matches/iter "
        f"[reps ex {['%.1f' % (v * 1e3) for v in reps_ex]} "
        f"match {['%.1f' % (v * 1e3) for v in reps_match]}]",
        file=sys.stderr,
    )

    # 1080p extraction (BASELINE config 3)
    H2, W2 = 1088, 1920
    cfg2 = SiftConfig(height=H2, width=W2, max_keypoints=4096)
    img2 = jax.device_put(
        jnp.asarray(fixtures.random_texture(H2, W2, seed=7, smooth=3)[None])
    )
    jax.block_until_ready(extract_features_jit(img2, cfg2))
    r2, f2 = _timed(lambda: extract_features_jit(img2, cfg2), 20, REPS)
    dt2 = min(r2)
    print(f"1080p: {dt2 * 1e3:.2f} ms/frame, {1 / dt2:.1f} fps, "
          f"{int(np.asarray(f2.count)[0])} kp", file=sys.stderr)

    # 4K extraction (config 3 upper end; the reference caps its working
    # dim at ~3200 px and would downsample 4K — this runs it native)
    H3, W3 = 2160, 3840
    cfg3 = SiftConfig(height=H3, width=W3, max_keypoints=8192)
    img3 = jax.device_put(
        jnp.asarray(fixtures.random_texture(H3, W3, seed=9, smooth=3)[None])
    )
    jax.block_until_ready(extract_features_jit(img3, cfg3))
    r3, f3 = _timed(lambda: extract_features_jit(img3, cfg3), 10, REPS)
    dt3 = min(r3)
    print(f"4K: {dt3 * 1e3:.2f} ms/frame, {1 / dt3:.1f} fps, "
          f"{int(np.asarray(f3.count)[0])} kp", file=sys.stderr)

    # large-set matcher (streams above MatchConfig.stream_threshold): 16k x
    # 16k descriptors, whose dense similarity buffer alone would be 1 GB
    rng16 = np.random.default_rng(3)
    N16 = 16384
    d0_16 = jax.device_put(
        jnp.asarray(rng16.integers(0, 256, (N16, 128), dtype=np.uint8)))
    d1_16 = jax.device_put(
        jnp.asarray(rng16.integers(0, 256, (N16, 128), dtype=np.uint8)))
    mcfg16 = MatchConfig(max_sift=N16, max_match=N16)
    jax.block_until_ready(match_descriptors(d0_16, d1_16, cfg=mcfg16))
    reps16, _ = _timed(
        lambda: match_descriptors(d0_16, d1_16, cfg=mcfg16), 20, REPS)
    dt16 = min(reps16)
    print(f"16k x 16k streaming match: {dt16 * 1e3:.2f} ms/pair",
          file=sys.stderr)

    # per-stage attribution: each stage jitted on its own, so the stage sum
    # exceeds the one-program total (stage boundaries are device syncs the
    # one program does not have)
    from siftgpu_tpu.pipeline.profile import profile_extraction

    times = profile_extraction(images, cfg, iters=40, mcfg=mcfg)
    stages = {k: round(v * 1e3, 3) for k, v in times.items()}
    print("stage table (640x480 b4, ms/iter): "
          + ", ".join(f"{k} {v}" for k, v in stages.items()),
          file=sys.stderr)

    print(
        json.dumps(
            {
                "metric": "keypoints+matches/s per chip",
                "platform": devs[0].platform,
                "device_kind": devs[0].device_kind,
                "device_count": len(devs),
                "card": card,
                "value": round(value, 1),
                "unit": "items/s",
                "vs_baseline": round(value / 60000.0, 3),
                "extract_640_ms": round(t_ex * 1e3, 2),
                "match_640_ms": round(t_match * 1e3, 2),
                "reps_640_ms": [round(v * 1e3, 2) for v in reps_ex],
                "reps_match_ms": [round(v * 1e3, 2) for v in reps_match],
                "ms_1080p": round(dt2 * 1e3, 3),
                "ms_4k": round(dt3 * 1e3, 3),
                "ms_match16k_stream": round(dt16 * 1e3, 3),
                "stages_640_ms": stages,
            }
        )
    )


if __name__ == "__main__":
    main()
