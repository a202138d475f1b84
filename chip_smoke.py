#!/usr/bin/env python
"""Smoke test of the main path on one GPU, checked against the CPU.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: distributed SLAM, then
                                  # data-parallel and spatial extraction,
                                  # each against the one-card run; nothing
                                  # else

One-card phases, each compared with the same code run on the CPU device of
the same process (`jax.devices("cpu")`):

  front end   640x480 batch 4 (2048 kp) with consecutive-pair matching,
              1080p (4096 kp) and 4K (8192 kp) extraction
  match16k    16384 x 16384 uint8 matching against an exact NumPy brute
              force on 256 seeded rows; guided matching (H gate, F gate)
              at 2048 x 2048 against the CPU run
  back end    two-view reconstruction and a 20-frame SLAM run at 640x480

Tolerances, and the precision behind each:
  keypoint-set overlap >= 0.95 with positions within 0.5 px: the pyramid's
      f32 products sum in another order on the GPU (f32 ulps), which can
      flip a candidate at the contrast or edge threshold;
  descriptors within 1 uint8 step where keypoints coincide (position
      within 1e-3 px, scale and orientation within 1e-3): the gradient
      planes are f32 on both devices and differ in the last bits of the
      pyramid's sums (printed for 640x480), so an element can cross one
      quantization boundary but not two;
  match-set overlap >= 0.95 (both endpoints within 0.5 px);
  known-warp inlier rate > 0.90 at < 1 px;
  16k matching, from the streaming best-2 stage the entry point runs at
      this size: best index identical to the int64 brute force; the second
      similarity within 5e-7 of the exact second cosine (the dot is an
      exact integer; two reciprocal square roots, each within 2^-22.9,
      and two f32 products), and the exact second column the only one that
      close; ratio decision identical;
  guided matching: pair sets agree >= 0.99 (gates are f32 at HIGHEST);
  two-view: rotation within 0.01 rad of ground truth and of the CPU run,
      translation direction within 0.02;
  SLAM: ATE <= CPU ATE + 1% of the trajectory span, and < 5% of the span.
--four, against the one-card run: the same keypoint, descriptor and ATE
bounds.

Prints the card's name and power limit, each phase's compile time, memory
analysis and peak device memory, each extraction's time per call, and as
its last line one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no such line, when JAX finds no GPU or any check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

# outside a checkout this import fails, before any output
from siftgpu_tpu.core import runtime

REPO = os.path.dirname(os.path.abspath(__file__))


# ----------------------------------------------------------------------------
# comparison helpers (CPU-tested: tests/test_chip_smoke.py)
# ----------------------------------------------------------------------------

def nearest_within(a: np.ndarray, b: np.ndarray, tol, chunk: int = 1024):
    """For each row of a [n, d], the index of the nearest row of b [m, d]
    under the max-norm, or -1 when none lies within `tol` (a scalar or a
    per-column [d] vector)."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    tol = np.broadcast_to(np.asarray(tol, np.float64), (a.shape[1],))
    out = np.full(len(a), -1, np.int64)
    if len(a) == 0 or len(b) == 0:
        return out
    for lo in range(0, len(a), chunk):
        d = np.abs(a[lo:lo + chunk, None, :] - b[None, :, :]) - tol
        d = d.max(axis=2)
        j = d.argmin(axis=1)
        ok = d[np.arange(len(j)), j] <= 0.0
        out[lo:lo + chunk] = np.where(ok, j, -1)
    return out


def set_overlap(a: np.ndarray, b: np.ndarray, tol) -> float:
    """Symmetric overlap of two point sets: the smaller of the fractions of
    a found in b and of b found in a (within `tol`, max-norm)."""
    if len(a) == 0 and len(b) == 0:
        return 1.0
    if len(a) == 0 or len(b) == 0:
        return 0.0
    fa = (nearest_within(a, b, tol) >= 0).mean()
    fb = (nearest_within(b, a, tol) >= 0).mean()
    return float(min(fa, fb))


def match_quads(x0, y0, x1, y1, pairs, count) -> np.ndarray:
    """[count, 4] (x0, y0, x1, y1) endpoints of a MatchResult's pairs."""
    p = np.asarray(pairs)[: int(count)]
    return np.stack(
        [np.asarray(x0)[p[:, 0]], np.asarray(y0)[p[:, 0]],
         np.asarray(x1)[p[:, 1]], np.asarray(y1)[p[:, 1]]], axis=1
    )


def inlier_rate(quads: np.ndarray, shift, tol: float = 1.0) -> float:
    """Fraction of matches whose second endpoint lies within `tol` px of
    the first moved by the known translation `shift` = (dx, dy)."""
    if len(quads) == 0:
        return 0.0
    err = np.hypot(quads[:, 2] - (quads[:, 0] + shift[0]),
                   quads[:, 3] - (quads[:, 1] + shift[1]))
    return float((err < tol).mean())


def cosines(d0_rows: np.ndarray, d1: np.ndarray) -> np.ndarray:
    """[n, m] cosines of uint8 descriptors; the integer dots are formed
    exactly (float64 holds them exactly)."""
    a = d0_rows.astype(np.float64)
    b = d1.astype(np.float64)
    return (a @ b.T) / np.maximum(
        np.sqrt((a * a).sum(1))[:, None] * np.sqrt((b * b).sum(1))[None, :],
        1e-300,
    )


def best2_reference(d0_rows: np.ndarray, d1: np.ndarray):
    """Exact best-2 by cosine of uint8 descriptors.
    Returns (best_j, second_j, best_cos, second_cos)."""
    cos = cosines(d0_rows, d1)
    best = cos.argmax(axis=1)
    rows = np.arange(len(cos))
    bc = cos[rows, best]
    masked = cos.copy()
    masked[rows, best] = -np.inf
    second = masked.argmax(axis=1)
    return best, second, bc, masked[rows, second]


def matcher_best2(d0, d1, cfg):
    """Per-row best column and second similarity of uint8 d0 against d1,
    from the streaming best-2 stage that `match_descriptors` runs at this
    shape under `cfg` (on d0's device)."""
    import jax
    import jax.numpy as jnp

    from siftgpu_tpu.frontend import match as M

    bs = M._effective_block(cfg, d1.shape[0])
    if not bs:
        raise ValueError(f"{d1.shape[0]} columns take the dense path")
    scfg = cfg.replace(block_size=bs)

    @jax.jit
    def run(x, y):
        _, second, best_j, _ = M._stream_best2(
            x, y, jnp.ones(x.shape[0], bool), jnp.ones(y.shape[0], bool), scfg)
        return best_j, second

    return run(d0, d1)


def second_columns(cos: np.ndarray, best: np.ndarray, second_sim,
                   tol: float) -> np.ndarray:
    """For each row of exact cosines [n, m], the one column other than
    `best` whose cosine lies within `tol` of the matcher's second
    similarity, or -1 when none or several do."""
    cos = cos.copy()
    cos[np.arange(len(cos)), best] = -np.inf
    near = np.abs(cos - np.asarray(second_sim, np.float64)[:, None]) <= tol
    return np.where(near.sum(axis=1) == 1, near.argmax(axis=1), -1)


def ratio_decision(best_cos, second_cos, dist_max: float, ratio_max: float):
    """The reference's angular distmax/ratiomax test."""
    best = np.arccos(np.clip(best_cos, -1.0, 1.0))
    second = np.arccos(np.clip(second_cos, -1.0, 1.0))
    return (best < dist_max) & (best < ratio_max * second)


def kp_table(f, b: int) -> np.ndarray:
    """[n, 4] (x, y, sigma, theta) of image b's valid keypoints."""
    m = np.asarray(f.mask[b])
    return np.stack([np.asarray(getattr(f, k)[b])[m]
                     for k in ("x", "y", "sigma", "theta")], axis=1)


def descriptor_agreement(fa, fb, b: int):
    """Descriptor agreement over the keypoints that coincide in both runs
    (position within 1e-3 px, scale and orientation within 1e-3).  Returns
    (how many coincide, the largest difference in uint8 steps, the lowest
    cosine between twin descriptors, a note on the worst keypoint)."""
    ka, kb = kp_table(fa, b), kp_table(fb, b)
    idx = nearest_within(ka, kb, (1e-3, 1e-3, 1e-3, 1e-3))
    sel = np.nonzero(idx >= 0)[0]
    if not len(sel):
        return 0, 0, 1.0, ""
    ma, mb = np.asarray(fa.mask[b]), np.asarray(fb.mask[b])
    da = np.asarray(fa.desc[b])[ma][sel].astype(np.float64)
    db = np.asarray(fb.desc[b])[mb][idx[sel]].astype(np.float64)
    worst = np.abs(da - db).max(axis=1)
    cos = (da * db).sum(1) / np.maximum(
        np.linalg.norm(da, axis=1) * np.linalg.norm(db, axis=1), 1e-12)
    note = ""
    if worst.max() > 1:
        i = int(worst.argmax())
        note = (f"; {int((worst > 1).sum())} kp beyond 1 step, worst at "
                f"(x, y, sigma, theta) {np.round(ka[sel[i]], 4).tolist()}")
    return len(sel), int(worst.max()), float(cos.min()), note


# ----------------------------------------------------------------------------
# reporting
# ----------------------------------------------------------------------------

class Report:
    def __init__(self):
        self.failed = []

    def check(self, name: str, ok: bool, detail: str) -> None:
        print(f"  {'PASS' if ok else 'FAIL'} {name}: {detail}", flush=True)
        if not ok:
            self.failed.append(name)


def _mem_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: none"
    return (f"memory_analysis: args {m.argument_size_in_bytes} B, "
            f"out {m.output_size_in_bytes} B, temp {m.temp_size_in_bytes} B")


def _peak(dev) -> str:
    stats = dev.memory_stats() or {}
    return f"peak_bytes_in_use {stats.get('peak_bytes_in_use', 'n/a')}"


def _desc_ok(n: int, steps: int, n_kp: int) -> bool:
    return n > 0.5 * n_kp and steps <= 1


def _desc_line(n: int, steps: int, cos: float, note: str) -> str:
    return (f"{n} coinciding kp, at most {steps} uint8 step(s) apart "
            f"(<= 1), lowest cosine {cos:.6f}{note}")


def _median_ms(compiled, *args, reps: int = 10) -> float:
    import jax

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def _compile(jitted, *args):
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def gradient_gap(x_dev, x_cpu, cfg):
    """Largest |difference| between the two devices' octave-0 gradient
    planes (gx and gy, every level), and the planes' largest magnitude."""
    import jax

    from siftgpu_tpu.frontend import orient, pyramid

    @jax.jit
    def planes(x):
        g = orient.gradient_stack(pyramid.build_pyramid(x, cfg)[0].gauss, cfg)
        return g.gx, g.gy

    a = [np.asarray(v, np.float64) for v in planes(x_dev)]
    b = [np.asarray(v, np.float64) for v in planes(x_cpu)]
    gap = max(float(np.abs(u - v).max()) for u, v in zip(a, b))
    return gap, max(float(np.abs(u).max()) for u in b)


def _warp_frames(H: int, W: int, B: int, seed: int):
    from siftgpu_tpu.oracle import fixtures

    base = fixtures.random_texture(H, W, seed=seed, smooth=3)
    frames = [base]
    for i in range(1, B):   # known shifts: consecutive pairs move (3, -2) px
        frames.append(
            fixtures.warp_affine(base, np.eye(2), np.array([3.0 * i, -2.0 * i]))
        )
    return np.stack(frames).astype(np.float32)


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------

def phase_front_end(rep: Report, dev, cpu, H: int, W: int, B: int, K: int,
                    match: bool, board: str) -> None:
    import jax

    from siftgpu_tpu import MatchConfig, SiftConfig, extract_features_jit
    from siftgpu_tpu.frontend.match import match_descriptors_batch

    cfg = SiftConfig(height=H, width=W, batch=B, max_keypoints=K)
    frames = _warp_frames(H, W, B, seed=0)
    x_dev = jax.device_put(frames, dev)
    compiled, t_c = _compile(extract_features_jit, x_dev, cfg)
    f_dev = jax.block_until_ready(compiled(x_dev))
    print(f"  extract compile {t_c:.2f} s on {board}; {_mem_line(compiled)}; "
          f"{_peak(dev)}; {_median_ms(compiled, x_dev):.3f} ms per call "
          f"(median of 10)", flush=True)
    f_cpu = extract_features_jit(jax.device_put(frames, cpu), cfg)
    if match:
        gap, top = gradient_gap(x_dev, jax.device_put(frames, cpu), cfg)
        print(f"  octave-0 gradient planes, gpu vs cpu: max |diff| {gap:.3e}"
              f" where the largest |g| is {top:.3e} ({gap / top:.2e} of it; "
              f"f32 eps 1.19e-07)", flush=True)

    for b in range(B):
        ka, kb = kp_table(f_dev, b), kp_table(f_cpu, b)
        ov = set_overlap(ka[:, :2], kb[:, :2], 0.5)
        rep.check(f"kp overlap img{b}", ov >= 0.95,
                  f"{ov:.4f} (gpu {len(ka)} kp, cpu {len(kb)} kp; >= 0.95)")
        n, steps, cos, note = descriptor_agreement(f_dev, f_cpu, b)
        rep.check(f"descriptors img{b}", _desc_ok(n, steps, len(ka)),
                  _desc_line(n, steps, cos, note))
    if not match:
        return

    mcfg = MatchConfig(max_sift=K, max_match=K)
    pair_fn = jax.jit(
        lambda desc, mask: match_descriptors_batch(
            desc[:-1], desc[1:], mask[:-1], mask[1:], mcfg)
    )
    mcomp, t_m = _compile(pair_fn, f_dev.desc, f_dev.mask)
    r_dev = jax.block_until_ready(mcomp(f_dev.desc, f_dev.mask))
    print(f"  match_descriptors_batch compile {t_m:.2f} s; "
          f"{_mem_line(mcomp)}; {_peak(dev)}", flush=True)
    r_cpu = pair_fn(f_cpu.desc, f_cpu.mask)
    for p in range(B - 1):
        qa = match_quads(f_dev.x[p], f_dev.y[p], f_dev.x[p + 1],
                         f_dev.y[p + 1], r_dev.pairs[p], r_dev.count[p])
        qb = match_quads(f_cpu.x[p], f_cpu.y[p], f_cpu.x[p + 1],
                         f_cpu.y[p + 1], r_cpu.pairs[p], r_cpu.count[p])
        ov = set_overlap(qa, qb, 0.5)
        rep.check(f"match overlap pair{p}", ov >= 0.95,
                  f"{ov:.4f} (gpu {len(qa)}, cpu {len(qb)} matches; >= 0.95)")
        rate = inlier_rate(qa, (3.0, -2.0))
        rep.check(f"inlier rate pair{p}", rate > 0.90,
                  f"{rate:.4f} at < 1 px (> 0.90)")


def _sixteen_k_sets(N: int, seed: int):
    rng = np.random.default_rng(seed)
    d0 = rng.integers(0, 256, (N, 128), dtype=np.uint8)
    d1 = rng.integers(0, 256, (N, 128), dtype=np.uint8)
    # half of d0 reappears in d1 with noise, at permuted positions
    src = rng.permutation(N)[: N // 2]
    dst = rng.permutation(N)[: N // 2]
    noisy = d0[src].astype(int) + rng.integers(-8, 9, (N // 2, 128))
    d1[dst] = np.clip(noisy, 0, 255).astype(np.uint8)
    return d0, d1


def phase_match16k(rep: Report, dev, board: str) -> None:
    import jax

    from siftgpu_tpu import MatchConfig
    from siftgpu_tpu.frontend import match as M

    N = 16384
    d0, d1 = _sixteen_k_sets(N, seed=3)
    cfg = MatchConfig(max_sift=N, max_match=N)
    a, b = jax.device_put(d0, dev), jax.device_put(d1, dev)
    entry = jax.jit(lambda x, y: M.match_descriptors_impl(x, y, cfg=cfg))
    compiled, t_c = _compile(entry, a, b)
    res = jax.block_until_ready(compiled(a, b))
    print(f"  match_descriptors 16k compile {t_c:.2f} s on {board}; "
          f"{_mem_line(compiled)}; {_peak(dev)}", flush=True)

    rows = np.sort(np.random.default_rng(11).choice(N, 256, replace=False))
    cos = cosines(d0[rows], d1)
    best, second, bc, sc = best2_reference(d0[rows], d1)
    gb, gs = (np.asarray(v)[rows] for v in matcher_best2(a, b, cfg))
    rep.check("16k best index", np.array_equal(gb, best),
              f"{int((gb == best).sum())}/256 rows identical")
    err = np.abs(gs.astype(np.float64) - sc)
    rep.check("16k second similarity", err.max() <= 5e-7,
              f"max |matcher - exact| {err.max():.2e} over 256 rows "
              f"(<= 5e-7)")
    gj = second_columns(cos, gb, gs, 5e-7)
    rep.check("16k second index", np.array_equal(gj, second),
              f"{int((gj == second).sum())}/256 rows identical")

    # ratio + mutual-best decision of the entry point on the sampled rows
    ratio_ok = ratio_decision(bc, sc, cfg.dist_max, cfg.ratio_max)
    col_best = best2_reference(d1[best], d0)[0]      # best row of each column
    want = ratio_ok & (col_best == rows)
    pairs = np.asarray(res.pairs)[: int(res.count)]
    got_j = dict(zip(pairs[:, 0].tolist(), pairs[:, 1].tolist()))
    got = np.array([r in got_j for r in rows.tolist()])
    same_j = all(got_j.get(r) == j for r, j, w in zip(rows, best, want) if w)
    rep.check("16k ratio decision", np.array_equal(got, want) and same_j,
              f"{int(want.sum())} accepted by the reference, "
              f"{int(got.sum())} by the matcher, "
              f"{int((got == want).sum())}/256 decisions identical")


def phase_guided(rep: Report, dev, cpu) -> None:
    import jax

    from siftgpu_tpu import MatchConfig
    from siftgpu_tpu.frontend.match import guided_match_descriptors

    N = 2048
    rng = np.random.default_rng(5)
    d0 = rng.integers(0, 256, (N, 128), dtype=np.uint8)
    d1 = rng.integers(0, 256, (N, 128), dtype=np.uint8)
    d1[: N // 2] = np.clip(d0[: N // 2].astype(int)
                           + rng.integers(-6, 7, (N // 2, 128)),
                           0, 255).astype(np.uint8)
    t = np.array([12.0, -7.0], np.float32)
    loc0 = rng.uniform((0, 0), (640, 480), (N, 2)).astype(np.float32)
    loc1 = rng.uniform((0, 0), (640, 480), (N, 2)).astype(np.float32)
    loc1[: N // 2] = loc0[: N // 2] + t
    H = np.array([[1, 0, t[0]], [0, 1, t[1]], [0, 0, 1]], np.float32)
    # pure image translation: epipolar lines run along t, F = [(tx, ty, 0)]x
    F = np.array([[0, 0, t[1]], [0, 0, -t[0]], [-t[1], t[0], 0]], np.float32)
    cfg = MatchConfig(max_sift=N, max_match=N)
    for gate, Hm, Fm in (("H", H, None), ("F", None, F)):
        outs = []
        for d in (dev, cpu):
            put = lambda v: None if v is None else jax.device_put(v, d)
            r = guided_match_descriptors(
                put(d0), put(d1), put(loc0), put(loc1), H=put(Hm), F=put(Fm),
                cfg=cfg)
            outs.append({tuple(p) for p in np.asarray(r.pairs)[: int(r.count)]})
        g, c = outs
        ov = len(g & c) / max(len(g | c), 1)
        rep.check(f"guided {gate} gate", ov >= 0.99 and len(g) > N // 4,
                  f"pair sets agree {ov:.4f} (gpu {len(g)}, cpu {len(c)}; "
                  f">= 0.99)")


def _rot_angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def phase_two_view(rep: Report, dev, cpu) -> None:
    import jax
    import jax.numpy as jnp

    from siftgpu_tpu import MatchConfig, SiftConfig
    from siftgpu_tpu.oracle import fixtures
    from siftgpu_tpu.pipeline import twoview

    H, W = 480, 640
    intr = (500.0, 500.0, W / 2.0, H / 2.0)
    t_gt = np.array([-0.4, 0.05, 0.02])
    img0, img1, meta = fixtures.two_plane_stereo(
        H, W, intr, np.array([0.01, -0.03, 0.005]), t_gt, seed=2)
    cfg = SiftConfig(height=H, width=W, batch=2, max_keypoints=2048)
    mcfg = MatchConfig(max_match=2048)
    res = []
    for d in (dev, cpu):
        with jax.default_device(d):
            t0 = time.perf_counter()
            r = twoview.two_view_reconstruct(
                jnp.stack([jnp.asarray(img0), jnp.asarray(img1)]),
                jnp.asarray(intr, jnp.float32), cfg, mcfg,
                jax.random.PRNGKey(7))
            R, tv = np.asarray(r.R), np.asarray(r.t)
            print(f"  two_view_reconstruct on {d.platform}: first call "
                  f"{time.perf_counter() - t0:.2f} s, {int(r.num_inliers)}/"
                  f"{int(r.num_matches)} inliers", flush=True)
        res.append((R, tv / np.linalg.norm(tv)))
    (Rg, tg), (Rc, tc) = res
    tgt = t_gt / np.linalg.norm(t_gt)
    rep.check("two-view R vs truth", _rot_angle(Rg @ meta["R"].T) < 0.01,
              f"{_rot_angle(Rg @ meta['R'].T):.5f} rad (< 0.01)")
    rep.check("two-view R vs cpu", _rot_angle(Rg @ Rc.T) < 0.01,
              f"{_rot_angle(Rg @ Rc.T):.5f} rad (< 0.01)")
    dt = min(np.abs(tg - tgt).max(), np.abs(tg + tgt).max())
    dtc = min(np.abs(tg - tc).max(), np.abs(tg + tc).max())
    rep.check("two-view t direction", dt < 0.02 and dtc < 0.02,
              f"vs truth {dt:.5f}, vs cpu {dtc:.5f} (< 0.02)")


def slam_scene(T: int = 20, H: int = 480, W: int = 640):
    from siftgpu_tpu import MatchConfig, SiftConfig
    from siftgpu_tpu.oracle import fixtures
    from siftgpu_tpu.pipeline import slam

    intr = (500.0, 500.0, W / 2.0, H / 2.0)
    frames, gt = fixtures.two_plane_sequence(
        T, H, W, intr,
        rvec_step=np.array([0.002, -0.004, 0.001]),
        t_step=np.array([-0.04, 0.006, 0.003]),
        d_near=5.0, d_far=10.0, seed=4,
    )
    cfg = SiftConfig(height=H, width=W, max_keypoints=2048)
    mcfg = MatchConfig(max_match=2048)
    scfg = slam.SlamConfig(kf_min_inliers=60, kf_flow_px=8.0,
                           init_flow_px=10.0)
    return frames, gt, intr, cfg, mcfg, scfg


def ate(traj, gt):
    from siftgpu_tpu.geometry import align

    est_c = align.camera_centers(traj)
    gt_c = align.camera_centers(gt)
    rmse, _ = align.ate_rmse(est_c, gt_c, with_scale=True)
    return float(rmse), float(np.linalg.norm(gt_c[-1] - gt_c[0]))


def phase_slam(rep: Report, dev, cpu) -> None:
    import jax

    from siftgpu_tpu.pipeline import slam

    frames, gt, intr, cfg, mcfg, scfg = slam_scene()
    out = []
    for d in (dev, cpu):
        with jax.default_device(d):
            t0 = time.perf_counter()
            r = slam.run_slam(frames, intr, cfg, mcfg, scfg)
            e, span = ate(r.trajectory, gt)
            print(f"  run_slam on {d.platform}: {time.perf_counter() - t0:.2f}"
                  f" s incl. compile, {len(r.keyframe_indices)} keyframes, "
                  f"ATE {e:.6f} (span {span:.4f})", flush=True)
        out.append((r, e, span))
    (rg, eg, span), (rc, ec, _) = out
    rep.check("slam ATE", eg <= ec + 0.01 * span and eg < 0.05 * span,
              f"gpu {eg:.6f} vs cpu {ec:.6f} (<= cpu + {0.01 * span:.6f}, "
              f"< {0.05 * span:.6f})")
    rot = max(_rot_angle(a @ b.T) for a, b in zip(_rots(rg.trajectory),
                                                   _rots(rc.trajectory)))
    rep.check("slam R vs cpu", rot < 0.01, f"max {rot:.5f} rad (< 0.01)")


def _rots(traj):
    import jax.numpy as jnp

    from siftgpu_tpu.geometry.pose import exp_so3

    return [np.asarray(exp_so3(jnp.asarray(np.asarray(w[:3], np.float64))))
            for w in traj]


def phase_four(rep: Report, devs, dev0) -> None:
    """An 8-frame distributed SLAM run and data-parallel and spatial
    extraction of the 640x480 batch on four cards, each against the
    one-card run.  The one-card SLAM run goes first, so the comparison
    that takes longest to compile is made before the extraction checks."""
    import jax
    from jax.sharding import Mesh

    from siftgpu_tpu import SiftConfig, extract_features_jit
    from siftgpu_tpu.parallel import dp, sequence, spatial
    from siftgpu_tpu.pipeline import slam

    def spread(tree, what):
        """Every array of 1 MiB or more spans all four cards."""
        bad = [a.shape for a in jax.tree_util.tree_leaves(tree)
               if isinstance(a, jax.Array) and a.nbytes >= 1 << 20
               and len(a.sharding.device_set) < len(devs)]
        rep.check(f"{what} spread", not bad,
                  f"arrays on fewer than {len(devs)} cards: {bad}")

    frames, gt, intr, cfg, mcfg, scfg = slam_scene(T=8)
    t0 = time.perf_counter()
    with jax.default_device(dev0):
        r1 = slam.run_slam(frames, intr, cfg, mcfg, scfg)
    e1, span = ate(r1.trajectory, gt)
    print(f"  run_slam on one card: {time.perf_counter() - t0:.2f} s incl. "
          f"compile, {len(r1.keyframe_indices)} keyframes, ATE {e1:.6f}",
          flush=True)
    t0 = time.perf_counter()
    rd = sequence.run_slam_distributed(frames, intr, cfg, mcfg, scfg,
                                       Mesh(np.array(devs), ("data",)))
    big = [a for a in jax.live_arrays() if a.nbytes >= 1 << 20]
    alone = [a.shape for a in big if a.sharding.device_set == {dev0}]
    rep.check("distributed slam spread", not alone,
              f"{len(big)} live arrays >= 1 MiB, on card 0 alone: {alone}")
    e4, _ = ate(rd.trajectory, gt)
    print(f"  run_slam_distributed: {time.perf_counter() - t0:.2f} s incl. "
          f"compile, {len(rd.keyframe_indices)} keyframes, ATE {e4:.6f}",
          flush=True)
    same_kf = rd.keyframe_indices == r1.keyframe_indices
    div = float(np.abs(rd.trajectory - r1.trajectory).max()) if same_kf \
        else float("nan")
    rep.check("distributed slam", e4 <= e1 + 0.01 * span and e4 < 0.05 * span,
              f"ATE 4 cards {e4:.6f} vs 1 card {e1:.6f} (<= 1 card + "
              f"{0.01 * span:.6f}); same keyframes {same_kf}, max trajectory "
              f"difference {div:.2e}")
    del r1, rd

    frames = _warp_frames(480, 640, 4, seed=0)
    cfg = SiftConfig(height=480, width=640, batch=4, max_keypoints=2048)
    f1 = extract_features_jit(jax.device_put(frames, dev0), cfg)
    for name, f4 in (
        ("dp", dp.extract_features_dp(
            frames, cfg, Mesh(np.array(devs), ("data",)))),
        ("spatial", spatial.extract_features_spatial(
            frames, cfg, Mesh(np.array(devs), ("spatial",)))),
    ):
        spread(jax.block_until_ready(f4), f"{name} output")
        for b in range(4):
            ov = set_overlap(kp_table(f4, b)[:, :2], kp_table(f1, b)[:, :2],
                             0.5)
            n, steps, cos, note = descriptor_agreement(f4, f1, b)
            rep.check(f"{name} img{b}",
                      ov >= 0.95 and _desc_ok(n, steps, len(f1.x[b])),
                      f"kp overlap {ov:.4f} (>= 0.95); "
                      + _desc_line(n, steps, cos, note))


# ----------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phases")
    args = ap.parse_args(argv)

    runtime.configure_compile_cache(REPO)
    import jax

    devs = jax.devices()
    print(f"jax {jax.__version__}; devices {devs}", flush=True)
    devs = runtime.require_gpu()
    board = runtime.gpu_board()
    print(f"device_kind {devs[0].device_kind}; nvidia-smi: {board}",
          flush=True)
    if args.four and len(devs) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devs)}")
    cpu = jax.devices("cpu")[0]
    dev = devs[0]
    rep = Report()

    if args.four:
        phases = [("four", lambda: phase_four(rep, devs[:4], dev))]
    else:
        phases = [
            ("front end 640x480 b4", lambda: phase_front_end(
                rep, dev, cpu, 480, 640, 4, 2048, True, board)),
            ("front end 1080p", lambda: phase_front_end(
                rep, dev, cpu, 1088, 1920, 1, 4096, False, board)),
            ("front end 4K", lambda: phase_front_end(
                rep, dev, cpu, 2160, 3840, 1, 8192, False, board)),
            ("match 16k", lambda: phase_match16k(rep, dev, board)),
            ("guided 2048", lambda: phase_guided(rep, dev, cpu)),
            ("two-view", lambda: phase_two_view(rep, dev, cpu)),
            ("slam", lambda: phase_slam(rep, dev, cpu)),
        ]
    for name, fn in phases:
        print(f"phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            rep.failed.append(name)
        print(f"phase {name} done in {time.perf_counter() - t0:.1f} s; "
              f"{_peak(dev)}", flush=True)

    if rep.failed:
        print(f"FAILED: {rep.failed}", flush=True)
        return 1
    print(f"card: {board}", flush=True)
    print(json.dumps({"ok": True, "device": runtime.device_record()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
