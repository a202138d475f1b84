"""Loop closure (SURVEY §7.2 step 9; BASELINE config 5 pose graph).

An out-and-back trajectory revisits its starting view: the revisit detector
must fire (measured loop edges), and the distributed pose graph must use them
to reduce accumulated drift — `pose_graph=True` must beat `pose_graph=False`
on ATE, on the virtual 8-device mesh.
"""

import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from siftgpu_tpu.core.config import MatchConfig, SiftConfig
from siftgpu_tpu.geometry import align
from siftgpu_tpu.oracle import fixtures
from siftgpu_tpu.parallel import sequence
from siftgpu_tpu.pipeline import slam

pytestmark = pytest.mark.slow


def _loop_scene(T=24, H=144, W=192, noise=0.05):
    """Camera translates out for T/2 frames, then returns to the start.

    Sensor noise + a deliberately weak BA (tiny window, few iterations, few
    keypoints) make odometry drift accumulate, so the measured loop edges
    have real drift to correct — on the clean fixture the windowed BA alone
    tracks to <1% ATE and a pose graph has nothing to do.  At noise 0.05 the
    uncorrected drift is ~28% of span and the correction recovers ~2x of it
    (measured end-only/online ratios 0.38-0.50), giving the ratio assertions
    a wide margin."""
    intr = (170.0, 170.0, W / 2.0, H / 2.0)
    half = T // 2
    t_step = np.array([-0.085, 0.012, 0.006])
    r_step = np.array([0.002, -0.004, 0.001])
    ks = np.concatenate([np.arange(half), np.arange(half - 2, -2, -1)])[:T]
    rvecs = np.outer(ks, r_step)
    tvecs = np.outer(ks, t_step)
    frames, gt = fixtures.two_plane_sequence_poses(
        rvecs, tvecs, H, W, intr, d_near=5.0, d_far=10.0, seed=4
    )
    rng = np.random.default_rng(11)
    frames = np.clip(
        frames + rng.normal(0.0, noise, frames.shape).astype(np.float32), 0, 1
    )
    cfg = SiftConfig(height=H, width=W, max_keypoints=384)
    mcfg = MatchConfig(max_match=384)
    scfg = slam.SlamConfig(
        kf_min_inliers=60, kf_flow_px=8.0, init_flow_px=10.0,
        kf_window=2, ba_iters=1, ba_cg=4, pnp_iters=4,
        loop_min_matches=25, loop_kf_gap=3,
    )
    return frames, gt, intr, cfg, mcfg, scfg


def test_loop_detected_and_pose_graph_reduces_ate():
    frames, gt, intr, cfg, mcfg, scfg = _loop_scene()
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "spatial"))

    plain = sequence.run_slam_distributed(
        frames, intr, cfg, mcfg, scfg, mesh, data_axis="data",
        pose_graph=False,
    )
    refined = sequence.run_slam_distributed(
        frames, intr, cfg, mcfg, scfg, mesh, data_axis="data",
        pose_graph=True,
    )

    # the revisit detector must have fired with a measured edge
    assert plain.loop_edges, "no loop closures detected on a loop trajectory"
    i, j, rel, w = plain.loop_edges[0][:4]
    assert j - i >= scfg.loop_kf_gap
    assert w >= scfg.loop_min_inliers

    gtc = align.camera_centers(gt)
    span = max(np.linalg.norm(gtc[k] - gtc[0]) for k in range(len(gtc)))
    ate_plain, _ = align.ate_rmse(align.camera_centers(plain.trajectory), gtc,
                                  with_scale=True)
    ate_ref, _ = align.ate_rmse(align.camera_centers(refined.trajectory), gtc,
                                with_scale=True)
    # the pose graph consumes the measured loop edges: it must measurably
    # reduce drift, not just leave the trajectory unchanged
    assert ate_ref < ate_plain * 0.9, (
        f"pose graph did not reduce drift: {ate_ref} vs {ate_plain}"
    )
    assert ate_ref < 0.2 * span, (ate_ref, span)


def test_loop_closure_survives_resume(tmp_path):
    """The revisit archive (retired keyframes' host descriptors) is
    checkpointed: a run resumed BEFORE the revisit must still detect the
    loop against pre-checkpoint keyframes and produce the uninterrupted
    run's edges."""
    from siftgpu_tpu.pipeline import checkpoint

    frames, gt, intr, cfg, mcfg, scfg = _loop_scene()
    full = slam.run_slam(frames, intr, cfg, mcfg, scfg)
    assert full.loop_edges

    Tc = 13  # out-leg only: no revisit has happened yet
    part = slam.run_slam(frames[:Tc], intr, cfg, mcfg, scfg)
    p = str(tmp_path / "ckpt.npz")
    checkpoint.save_slam_state(p, part, next_frame=Tc, kf_window=scfg.kf_window)
    resumed = slam.run_slam(
        frames, intr, cfg, mcfg, scfg, resume=checkpoint.load_slam_state(p)
    )
    assert [(e[0], e[1]) for e in resumed.loop_edges] == [
        (e[0], e[1]) for e in full.loop_edges
    ], "resume lost the loop-closure archive"
    np.testing.assert_allclose(
        np.stack([e[2] for e in resumed.loop_edges]),
        np.stack([e[2] for e in full.loop_edges]), atol=1e-4,
    )


def test_online_correction_preserves_detection_and_corrects(tmp_path):
    """VERDICT r3 task 5: online corrections (default on) must fire, must NOT
    starve later revisit detection (the failure mode of naive mid-run
    correction: a corrupted map makes every later loop PnP fail), and the
    final trajectory must beat the uncorrected run decisively."""
    import dataclasses

    from siftgpu_tpu.pipeline import metrics as metrics_mod

    frames, gt, intr, cfg, mcfg, scfg = _loop_scene()
    gtc = align.camera_centers(gt)

    mfile = str(tmp_path / "m.jsonl")
    ml = metrics_mod.MetricsLogger(mfile)
    online = slam.run_slam(frames, intr, cfg, mcfg, scfg, metrics=ml)
    ml.close() if hasattr(ml, "close") else None
    slam.apply_pose_graph_sim3(
        online.keyframes, online.trajectory, online.map_points,
        online.map_mask, online.map_anchor, online.loop_edges,
        odo_edges=online.odo_edges,
    )

    endonly = slam.run_slam(
        frames, intr, cfg, mcfg,
        dataclasses.replace(scfg, loop_online=False),
    )
    slam.apply_pose_graph_sim3(
        endonly.keyframes, endonly.trajectory, endonly.map_points,
        endonly.map_mask, endonly.map_anchor, endonly.loop_edges,
        odo_edges=endonly.odo_edges,
    )

    plain = slam.run_slam(
        frames, intr, cfg, mcfg,
        dataclasses.replace(scfg, loop_online=False, loop_fuse=False),
    )

    # at least one online correction fired (metrics stream records it)
    with open(mfile) as f:
        events = f.read()
    assert '"loop_correction"' in events, "no online correction applied"

    # detection was NOT starved by the corrections: the online run finds
    # (at least nearly) as many revisits as the untouched run
    assert len(online.loop_edges) >= len(plain.loop_edges) - 1, (
        len(online.loop_edges), len(plain.loop_edges),
    )

    ate_on, _ = align.ate_rmse(
        align.camera_centers(online.trajectory), gtc, with_scale=True)
    ate_end, _ = align.ate_rmse(
        align.camera_centers(endonly.trajectory), gtc, with_scale=True)
    ate_plain, _ = align.ate_rmse(
        align.camera_centers(plain.trajectory), gtc, with_scale=True)
    # decisive correction, and online within a modest factor of end-only
    # (online pays mid-run snap noise; its value is usable mid-run state)
    assert ate_on < 0.7 * ate_plain, (ate_on, ate_plain)
    assert ate_on < 1.4 * ate_end, (ate_on, ate_end)


def _two_loop_scene(H=144, W=192, noise=0.05):
    """Out-back-out-back trajectory: the FIRST revisit (~frame 18) closes a
    loop mid-run, and a substantial post-loop tail (a second outbound leg
    over already-mapped ground + a second return) follows.  This is the
    fixture VERDICT r4 task 7 asks for: it separates what online correction
    buys DURING the run from what an end-of-run refine recovers anyway."""
    intr = (170.0, 170.0, W / 2.0, H / 2.0)
    half = 10
    ks = np.concatenate([
        np.arange(half),                 # out:   0..9
        np.arange(half - 2, -1, -1),     # back:  8..0   (first loop closes)
        np.arange(1, half + 1),          # out2:  1..10  (post-loop tail)
        np.arange(half - 1, 0, -1),      # back2: 9..1   (second revisit)
    ])
    T = len(ks)
    t_step = np.array([-0.085, 0.012, 0.006])
    r_step = np.array([0.002, -0.004, 0.001])
    rvecs = np.outer(ks, r_step)
    tvecs = np.outer(ks, t_step)
    frames, gt = fixtures.two_plane_sequence_poses(
        rvecs, tvecs, H, W, intr, d_near=5.0, d_far=10.0, seed=4
    )
    rng = np.random.default_rng(11)
    frames = np.clip(
        frames + rng.normal(0.0, noise, frames.shape).astype(np.float32), 0, 1
    )
    cfg = SiftConfig(height=H, width=W, max_keypoints=384)
    mcfg = MatchConfig(max_match=384)
    scfg = slam.SlamConfig(
        kf_min_inliers=60, kf_flow_px=8.0, init_flow_px=10.0,
        kf_window=2, ba_iters=1, ba_cg=4, pnp_iters=4,
        loop_min_matches=25, loop_kf_gap=3,
    )
    return frames, gt, intr, cfg, mcfg, scfg, T


def test_online_correction_affirmative_value(tmp_path):
    """VERDICT r4 task 7: online correction's value asserted AFFIRMATIVELY on
    a two-loop fixture with a long post-loop tail, not as ATE-within-1.4x.

    (a) mid-run state: right after the first loop fully closes, the
        trajectory-so-far (what a mid-run consumer would read) is decisively
        more accurate than the loop_online=False run's state at the same
        frame — measured by prefix runs (== the full run's causal state at
        that frame; the final trajectory is not, since later corrections
        rewrite history), aligned on the frozen pre-loop chain and
        evaluated at the CURRENT pose.  Whole-prefix Sim(3) ATE hides the
        value (the uncorrected early segment dominates the RMS in both
        runs — measured 0.175 vs 0.164);
    (b) post-loop tail tracking: PnP inliers over the tail do not degrade
        relative to the uncorrected run.

    The four SLAM runs execute in a FRESH subprocess
    (tests/loop_value_worker.py): their compile volume reliably pushed a
    long-lived xdist worker over the cumulative XLA:CPU segfault threshold
    (crashed the worker twice in full-suite runs while passing standalone
    every time — see pyproject.toml's addopts note)."""
    import subprocess
    import sys as _sys

    out = tmp_path / "loop_value.npz"
    worker = os.path.join(os.path.dirname(__file__), "loop_value_worker.py")
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    extra = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = os.pathsep.join(p for p in [repo, extra] if p)
    env["JAX_PLATFORMS"] = "cpu"   # CPU-only children
    proc = subprocess.run(
        [_sys.executable, worker, str(out)], env=env, timeout=1100,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    assert proc.returncode == 0, proc.stdout.decode(errors="replace")[-4000:]
    res = np.load(out)

    assert int(res["n_corrections"]) >= 1, (
        "no online correction fired on the two-loop fixture"
    )
    # first correction lands mid-run, before the second outbound leg ends
    assert int(res["t_corr"]) < 28, int(res["t_corr"])

    err_on, err_off = float(res["err_on"]), float(res["err_off"])
    assert err_on < 0.6 * err_off, (
        f"online correction bought no mid-run accuracy: current-pose error "
        f"{err_on:.4f} vs uncorrected {err_off:.4f}"
    )

    ti_on, ti_off = float(res["tail_inl_on"]), float(res["tail_inl_off"])
    assert ti_on > 0.8 * ti_off, (
        f"online correction destabilized tail tracking: "
        f"mean inliers {ti_on:.1f} vs {ti_off:.1f}"
    )
