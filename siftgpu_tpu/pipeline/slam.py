"""Incremental monocular SLAM loop (the north-star back end, BASELINE.json:5).

Host-orchestrated sequential loop over jitted fixed-shape device kernels —
the same structure as production systems: the device does extraction,
matching, PnP, triangulation and windowed BA; the host does keyframe/map
bookkeeping (slot allocation) between steps.

Pipeline per frame:
  extract -> match against the last keyframe -> 2D-3D PnP (robust GN) ->
  keyframe decision -> [new KF: triangulate unmapped matches, insert map
  points, windowed Schur-complement BA over the last W keyframes]

World frame = camera 0; monocular scale is fixed by the bootstrap baseline
(|t| = 1).  Trajectory accuracy is evaluated with Sim(3)-aligned ATE
(geometry/align.py), matching the BASELINE metric definition.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional

import jax
import numpy as np

__all__ = [
    "SlamConfig", "Keyframe", "SlamResult", "run_slam",
    "apply_pose_graph_sim3",
]


@partial(jax.jit, static_argnums=(3, 4))
def _track_step_jit(frame, kf_desc, kf_mask, cfg, mcfg):
    """ONE dispatch per tracked frame: extraction fused with matching against
    the P (<=2) live keyframes (stacked descriptor buffers), instead of one
    dispatch and one host sync per match.  Returns (feats, pairs [P, M, 2],
    counts [P])."""
    from ..frontend.extract import extract_features
    from ..frontend.match import match_descriptors_impl

    feats = extract_features(frame[None], cfg)
    res = jax.vmap(
        lambda d0, m0: match_descriptors_impl(
            d0, feats.desc[0], m0, feats.mask[0], mcfg
        )
    )(kf_desc, kf_mask)
    return feats, res.pairs, res.count


@partial(jax.jit, static_argnums=4)
def _match_kf_jit(kf_desc, kf_mask, f_desc, f_mask, mcfg):
    """Match-only variant of `_track_step_jit` for pre-extracted sequences
    (parallel/sequence.py): the frame's descriptors are already on device."""
    from ..frontend.match import match_descriptors_impl

    res = jax.vmap(
        lambda d0, m0: match_descriptors_impl(d0, f_desc, m0, f_mask, mcfg)
    )(kf_desc, kf_mask)
    return res.pairs, res.count


@partial(jax.jit, static_argnums=4)
def _loop_match_jit(arch_desc, arch_mask, cur_desc, cur_mask, mcfg):
    """Loop-closure revisit detection: ONE batched dispatch matching the new
    keyframe's descriptors against ALL archived (retired) keyframes.
    arch_desc: [C, K, 128] (capacity-bucketed so shapes — and compiles —
    stay stable as the archive grows).  Returns (pairs [C, M, 2], counts [C])."""
    from ..frontend.match import match_descriptors_impl

    res = jax.vmap(
        lambda d0, m0: match_descriptors_impl(d0, cur_desc, m0, cur_mask, mcfg)
    )(arch_desc, arch_mask)
    return res.pairs, res.count


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    max_map_points: int = 4096
    kf_window: int = 4             # windowed BA span (keyframes)
    kf_min_inliers: int = 80       # new KF when tracking inliers drop below
    kf_flow_px: float = 12.0       # ... or median flow vs last KF exceeds
    pnp_iters: int = 10
    huber_px: float = 3.0
    inlier_px: float = 3.0
    ba_iters: int = 6
    ba_cg: int = 20
    min_depth: float = 0.05
    max_depth: float = 1e3
    tri_reproj_px: float = 2.0
    # bootstrap parallax requirement: below ~10 px the essential matrix is
    # rotation-dominated and the initial map is unusable
    init_flow_px: float = 10.0
    # --- tracking-loss state + relocalization (VERDICT r4 task 3) ---
    # Below `lost_min_inliers` PnP inliers tracking has FAILED (occlusion,
    # blur, blackout) rather than "the scene moved": the tracker enters a
    # LOST state that freezes the pose and the velocity model and — the
    # critical fix — inserts NO keyframes and triangulates NOTHING (the r4
    # trigger `n_inl < kf_min_inliers` conflated the two, so a failure
    # *satisfied* the keyframe condition and garbage-pose keyframes
    # permanently poisoned the map).  Recovery is automatic when live-KF
    # matching yields a confident PnP again; `relocalize` additionally
    # re-registers against the ARCHIVED keyframe database (one batched
    # match + PnP seeded from the matched keyframe's pose), which handles
    # the camera re-emerging over a region the live keyframes don't see.
    # `track_lost=False` restores the legacy conflated trigger.
    track_lost: bool = True
    lost_min_inliers: int = 10
    relocalize: bool = True
    reloc_min_matches: int = 20    # descriptor matches to try a candidate
    reloc_min_inliers: int = 10    # PnP inliers to accept re-registration
    # --- loop closure (SURVEY §7.2 step 9) --- detect revisits by matching
    # each new keyframe against the archived descriptors of RETIRED keyframes
    # (one batched dispatch), verify with PnP against the old map region, and
    # record a measured relative-pose edge for the pose-graph stage
    loop_closure: bool = True
    loop_min_matches: int = 30     # descriptor matches to consider a revisit
    loop_kf_gap: int = 4           # min keyframe-index separation of a pair
    # min FRAME separation: nearby-in-time keyframes overlap views without
    # being revisits, and their edges are measured in the LOCAL map scale —
    # monocular scale drift makes such edges inconsistent with the global
    # frame, poisoning the SE(3) pose graph.  True revisits (long temporal
    # gap, matched against the pre-drift map origin region) are the edges
    # that carry drift information.
    loop_min_frame_gap: int = 12
    loop_min_inliers: int = 12     # PnP inliers to accept the loop edge
    # measure relative SCALE on loop edges from the revisit pair's
    # duplicated map points (feeds the Sim(3) pose graph's lambda
    # component).  Sound since round 4: both clouds come from the CURRENT
    # map (retirement-time snapshots were tried and REJECTED — see the
    # rationale in detect_loop), compared as a median pairwise-distance
    # ratio in each camera's local frame and gated on ratio-spread
    # consistency, so coherent windowed-BA point drift cancels instead of
    # contaminating the measurement (VERDICT r3 task 8 — was off by
    # default before that fix).
    loop_sim3_scale: bool = True
    # apply loop corrections ONLINE: when a loop edge is accepted, run the
    # Sim(3) pose graph over the current keyframe chain immediately, correct
    # keyframe poses + trajectory prefix + MAP points, and fuse the
    # duplicated landmarks — tracking then continues against the corrected
    # state instead of drifting on for the rest of the sequence
    # (VERDICT r3 missing #3 / task 5)
    loop_online: bool = True
    # minimum PnP inliers before an edge is trusted for ONLINE application
    # (weaker accepted edges still feed the end-of-run refinement, where
    # many edges balance each other).  Measured on the noisy loop fixture:
    # applying a 13-inlier edge immediately moved keyframes by up to 0.84
    # and the corrupted state made every later revisit PnP fail (2 edges
    # accumulated instead of 11; end-ATE 0.24 vs 0.12 end-only).
    loop_online_min_inliers: int = 25
    # ONLINE corrections fire only when the measured loop discrepancy
    # exceeds this many median keyframe steps — when drift is within
    # tracking noise, a mid-run snap just injects the edge's measurement
    # noise (the end-of-run refinement still consumes the edge either way)
    loop_online_min_drift: float = 1.0
    # ONLINE corrections snap only the last `loop_online_free_kfs` keyframes
    # (+ their map points) onto the loop constraint; the established chain
    # and its map stay FROZEN so later revisit detection runs against
    # internally-consistent old geometry (transporting the whole old map
    # online warped it non-rigidly: later loop-PnP inlier ratios halved and
    # detection starved — 6 edges instead of 16 on the T=32 fixture).  The
    # end-of-run refinement over stored odometry measurements distributes
    # the snaps across the whole chain.
    loop_online_free_kfs: int = 6
    # fuse duplicated landmarks identified by the loop match (same physical
    # point in an old slot AND a new slot): remap new -> old in every
    # keyframe's pt_ids and free the new slot (VERDICT r3 missing #1)
    loop_fuse: bool = True


@dataclasses.dataclass
class Keyframe:
    frame_idx: int
    pose: np.ndarray        # [6] world->cam twist
    feats: object           # device Features (batch 1)
    kp: dict                # host copies: x, y, desc, mask
    pt_ids: np.ndarray      # [K] map slot per keypoint (-1 = none)


@dataclasses.dataclass
class SlamResult:
    trajectory: np.ndarray  # [T, 6] per-frame world->cam twists
    keyframe_indices: List[int]
    map_points: np.ndarray  # [M, 3]
    map_mask: np.ndarray    # [M]
    num_tracked: List[int]  # PnP inliers per frame
    keyframes: Optional[List["Keyframe"]] = None  # host keyframe objects
    # constant-velocity tracker state at the end of the run — checkpointed so
    # a resumed run replays the uninterrupted one exactly (SURVEY §5.4)
    vel: Optional[np.ndarray] = None
    # measured loop-closure constraints: (kf_i, kf_j, rel_sim3 [7], weight,
    # fuse_pairs [F, 2]) — rel_sim3 is the measured relative Sim(3)
    # cam_i -> cam_j in the [omega, t, log_scale] chart
    # (optim/pose_graph.srt_to_sim7), with kf_* indexing
    # `keyframes`/`keyframe_indices`; fuse_pairs lists (old_slot, new_slot)
    # duplicated-landmark map slots the revisit match identified.  Consumed
    # by `apply_pose_graph_sim3` (online + parallel/sequence.py's final
    # refinement).  Tuples may be 4 long in legacy checkpoints.
    loop_edges: Optional[List[tuple]] = None
    # anchor keyframe (index into `keyframes`) of each map slot — the
    # keyframe whose insertion triangulated the point; loop corrections move
    # each point with its anchor's Sim(3) correction (VERDICT r3 task 3)
    map_anchor: Optional[np.ndarray] = None
    # slot-allocation high-water mark: landmark fusion frees slots below it,
    # so map_mask.sum() does NOT recover it — checkpoints persist it for
    # exact-replay resume
    map_n: Optional[int] = None
    # stored odometry MEASUREMENTS [(kf_a, kf_b, rel_sim7), ...] recorded at
    # windowed-BA time (consecutive + skip-1 keyframe pairs) — the honest
    # edges the final pose graph optimizes against (they keep their
    # insertion-time values across online corrections, so the graph can
    # distribute accumulated online snaps over the whole chain)
    odo_edges: Optional[List[tuple]] = None


def _host_kp(feats):
    m = np.asarray(feats.mask[0])
    return dict(
        x=np.asarray(feats.x[0]), y=np.asarray(feats.y[0]),
        desc=feats.desc[0], mask=m,
    )


def apply_pose_graph_sim3(
    keyframes, trajectory, map_X, map_mask, map_anchor, loop_edges,
    optimizer=None, iters: int = 10, loop_weight: float = 8.0,
    upto_frame: Optional[int] = None, fuse: bool = True,
    odo_edges=None, n_fix: int = 1,
) -> bool:
    """Sim(3) pose-graph correction over the keyframe chain, applied to the
    WHOLE SLAM state in place: keyframe poses, the trajectory (keyframe rows
    exactly, non-keyframe rows re-anchored to their preceding keyframe), the
    MAP (each point rides its anchor keyframe's Sim(3) correction, each
    retired keyframe's landmark snapshot rides its own), and the duplicated
    landmarks the loop matches identified are fused (new slot -> old slot).

    Graph: odometry edges (consecutive + skip-1 keyframe relative poses at
    the current optimum, relative scale 1 — they hold the chain's local
    shape) + the measured loop edges, inlier-weighted.  Without loop edges
    this is a no-op (returns False): odometry residuals are ~0 at the
    current estimate.

    `optimizer`: callable (Sim3PoseGraph, iters, n_fix) -> (graph, costs);
    defaults to the dense single-device solver for tiny graphs and the
    matrix-free PCG solver beyond 64 nodes (`parallel.sequence.
    _pose_graph_refine` passes the edge-sharded distributed equivalents).
    `upto_frame` bounds the trajectory rows touched (online use: frames
    beyond the current one are not yet tracked).  Mutates
    `map_X`/`map_mask`/`trajectory` in place; returns True iff a correction
    was applied.

    `odo_edges`: optional stored odometry MEASUREMENTS [(i, j, rel7), ...]
    (recorded at keyframe insertion / windowed-BA time by `run_slam`) — the
    honest graph formulation.  When absent, odometry edges are derived from
    the CURRENT poses (zero-residual; they only hold the chain's local
    shape).  `n_fix` freezes the first n keyframes — the ONLINE correction
    policy: the established chain and its map stay put (so revisit
    detection against old regions keeps working on internally-consistent
    geometry — transporting the whole old map warped it non-rigidly and
    measurably halved later loop-PnP inlier ratios), and only the recent
    segment snaps onto the loop constraint; the END-of-run full graph
    (n_fix=1) with stored odometry measurements then distributes the
    accumulated snaps over the whole chain.

    Map-point transform: for anchor keyframe with pre-correction pose
    (R_o, t_o) and optimized Sim(3) node (s, R, t), a point moves as
    X' = (1/s) R^T ((R_o X + t_o) - t) — its camera-frame position scales
    by 1/s, consistent with folding the node to the SE(3) pose (R, t/s).
    """
    import jax.numpy as jnp

    from ..geometry import pose as P
    from ..optim import pose_graph as pg

    kfs = keyframes
    if kfs is None or len(kfs) < 3 or not loop_edges:
        return False
    loops = [e for e in loop_edges if e[1] < len(kfs)]
    if not loops:
        return False
    Mk = len(kfs)
    poses6 = jnp.asarray(np.stack([k.pose for k in kfs]))
    R0, t0 = P.exp_se3(poses6)
    poses = pg.srt_to_sim7(jnp.ones(Mk), R0, t0)
    if odo_edges is not None:
        odo = [e for e in odo_edges if e[0] < Mk and e[1] < Mk]
        # legacy resumes may lack early measurements: fill missing
        # consecutive pairs from the current poses so the chain stays
        # connected (zero-residual shape-holding edges)
        have = {(int(e[0]), int(e[1])) for e in odo}
        miss = [i for i in range(Mk - 1) if (i, i + 1) not in have]
        if miss:
            mi = jnp.asarray(miss, jnp.int32)
            Rr_m, tr_m = P.relative(R0[mi], t0[mi], R0[mi + 1], t0[mi + 1])
            rel_m = np.asarray(
                pg.srt_to_sim7(jnp.ones(len(miss)), Rr_m, tr_m), np.float32
            )
            odo = odo + [(i, i + 1, rel_m[n]) for n, i in enumerate(miss)]
        ei = jnp.asarray([e[0] for e in odo], jnp.int32)
        ej = jnp.asarray([e[1] for e in odo], jnp.int32)
        t_meas = jnp.asarray(np.stack([e[2] for e in odo]), jnp.float32)
    else:
        ei, ej = [], []
        for i in range(Mk - 1):
            ei.append(i)
            ej.append(i + 1)
            if i + 2 < Mk:
                ei.append(i)
                ej.append(i + 2)
        ei = jnp.asarray(ei, jnp.int32)
        ej = jnp.asarray(ej, jnp.int32)
        Rr, tr = P.relative(R0[ei], t0[ei], R0[ej], t0[ej])
        t_meas = pg.srt_to_sim7(jnp.ones(ei.shape[0]), Rr, tr)
    weight = jnp.ones(ei.shape[0])
    ei = jnp.concatenate([ei, jnp.asarray([e[0] for e in loops], jnp.int32)])
    ej = jnp.concatenate([ej, jnp.asarray([e[1] for e in loops], jnp.int32)])
    t_meas = jnp.concatenate(
        [t_meas, jnp.asarray(np.stack([e[2] for e in loops]), jnp.float32)]
    )
    # information-proportional edge weights: a loop verified by more PnP
    # inliers is a better-conditioned measurement
    weight = jnp.concatenate(
        [weight, jnp.asarray(
            [loop_weight * e[3] / 80.0 for e in loops], jnp.float32)]
    )
    graph = pg.Sim3PoseGraph(
        poses=poses, edge_i=ei, edge_j=ej, t_meas=t_meas, weight=weight,
    )
    n_fix = max(1, min(n_fix, Mk - 1))
    if optimizer is not None:
        out, _ = optimizer(graph, iters, n_fix)
    elif Mk <= 64:
        out, _ = pg.optimize_pose_graph_sim3(graph, iters=iters, n_fix=n_fix)
    else:  # dense is O(M^3)/iter: matrix-free PCG beyond tiny graphs
        out, _ = pg.optimize_pose_graph_sim3_cg(graph, iters=iters,
                                                n_fix=n_fix)
    s_f, R_f, t_f = pg.sim7_to_srt(jnp.asarray(out.poses))
    # fold scale into SE(3): x_cam = s R x + t  <=>  x_cam/s = R x + t/s —
    # the camera center and orientation of [R, t/s]
    new_poses = np.asarray(
        P.log_se3(R_f, t_f / s_f[..., None]), np.float32
    )
    s_fn = np.asarray(s_f)
    R_fn = np.asarray(R_f)
    t_fn = np.asarray(t_f)
    R_on = np.asarray(R0)
    t_on = np.asarray(t0)

    # ---- map repair: each point rides its anchor keyframe's correction ----
    if map_anchor is not None:
        sel = np.nonzero(map_mask & (map_anchor >= 0) & (map_anchor < Mk))[0]
        if len(sel):
            a = map_anchor[sel]
            xc = np.einsum("mij,mj->mi", R_on[a], map_X[sel]) + t_on[a]
            map_X[sel] = (
                np.einsum("mji,mj->mi", R_fn[a], xc - t_fn[a])
                / s_fn[a][:, None]
            )
    # ---- trajectory: keyframe rows exact, others re-anchored ----
    old_poses = np.stack([k.pose for k in kfs])
    kf_rows = np.asarray([k.frame_idx for k in kfs])
    T_total = len(trajectory)
    if upto_frame is not None:
        T_total = min(T_total, upto_frame + 1)
    rows = np.arange(T_total)
    anchor = np.maximum(np.searchsorted(kf_rows, rows, "right") - 1, 0)
    Rt, tt = P.exp_se3(jnp.asarray(trajectory[:T_total]))
    Ro, to = P.exp_se3(jnp.asarray(old_poses[anchor]))
    Rn, tn = P.exp_se3(jnp.asarray(new_poses[anchor]))
    Rrel, trel = P.compose(Rt, tt, *P.inverse(Ro, to))
    Rtn, ttn = P.compose(Rrel, trel, Rn, tn)
    traj_new = np.array(P.log_se3(Rtn, ttn), np.float32)
    kf_in = kf_rows[kf_rows < T_total]
    traj_new[kf_in] = new_poses[: len(kf_in)]
    trajectory[:T_total] = traj_new
    for i, k in enumerate(kfs):
        k.pose = new_poses[i]

    # ---- fuse duplicated landmarks (new slot -> old slot) ----
    if fuse:
        remap = {}
        for e in loops:
            fp = e[4] if len(e) > 4 else None
            if fp is None:
                continue
            for o_s, n_s in np.asarray(fp).reshape(-1, 2):
                o_s, n_s = int(o_s), int(n_s)
                while o_s in remap:   # follow prior fusions of the old slot
                    o_s = remap[o_s]
                if o_s == n_s or not map_mask[n_s] or not map_mask[o_s]:
                    continue
                remap[n_s] = o_s
                map_mask[n_s] = False
        if remap:
            lut = np.arange(len(map_mask))
            for n_s, o_s in remap.items():
                lut[n_s] = o_s
            for _ in range(8):        # path-compress fusion chains
                lut2 = lut[lut]
                if (lut2 == lut).all():
                    break
                lut = lut2
            for k in kfs:
                ids = getattr(k, "pt_ids", None)
                if ids is not None and ids.size:
                    pos = ids >= 0
                    ids[pos] = lut[ids[pos]]
    return True


def refit_map_points(keyframes, map_X, map_mask, intr, iters: int = 3):
    """Points-only Huber refit against the (pinned) current keyframe poses —
    `optim.ba.refine_points` over every observation the keyframes carry.

    Run after a Sim(3) pose-graph correction: the anchor transport is exact
    for each point's own anchor but slightly non-rigid across anchor
    boundaries, and the residual inconsistency measurably starved later
    revisit PnPs (inlier ratios halved on the loop fixtures).  Poses stay
    fixed so the refit cannot re-open the loop the way full BA does.
    Shapes are bucketed (pow2 obs/cams, weight-0 padding) so repeated
    online corrections hit the jit cache.  Mutates map_X in place."""
    import jax.numpy as jnp

    from ..optim import ba

    kfs = [
        k for k in keyframes
        if isinstance(getattr(k, "kp", None), dict)
        and k.kp.get("x") is not None and k.pt_ids.size
    ]
    if len(kfs) < 2:
        return
    obs_c, obs_p, obs_uv = [], [], []
    for ci, k in enumerate(kfs):
        sel = np.nonzero(k.pt_ids >= 0)[0]
        obs_c += [ci] * len(sel)
        obs_p += list(k.pt_ids[sel])
        obs_uv += list(np.stack([np.asarray(k.kp["x"])[sel],
                                 np.asarray(k.kp["y"])[sel]], 1))
    n = len(obs_c)
    if n < 10:
        return
    nb = 1
    while nb < n:
        nb *= 2
    mb = 1
    while mb < len(kfs):
        mb *= 2
    cams = np.zeros((mb, 6), np.float32)
    cams[: len(kfs)] = np.stack([k.pose for k in kfs])
    ci_a = np.zeros(nb, np.int32)
    pi_a = np.zeros(nb, np.int32)
    uv_a = np.zeros((nb, 2), np.float32)
    w_a = np.zeros(nb, np.float32)
    ci_a[:n] = obs_c
    pi_a[:n] = obs_p
    uv_a[:n] = np.stack(obs_uv)
    w_a[:n] = 1.0
    prob = ba.BAProblem(
        cams=jnp.asarray(cams), points=jnp.asarray(map_X),
        intrinsics=jnp.asarray(intr, jnp.float32),
        cam_idx=jnp.asarray(ci_a), pt_idx=jnp.asarray(pi_a),
        uv=jnp.asarray(uv_a), w=jnp.asarray(w_a),
    )
    map_X[:] = np.asarray(ba.refine_points(prob, iters))


def run_slam(frames, intr, cfg, mcfg, scfg: SlamConfig,
             gt_for_debug: Optional[np.ndarray] = None,
             resume=None, features=None, ba_fn=None,
             metrics=None, checkpoint_path=None, pg_fn=None) -> SlamResult:
    """frames: [T, H, W] float array; intr: (fx, fy, cx, cy).

    `resume`: a `checkpoint.SlamCheckpoint` — restores the map, trajectory
    prefix and last keyframe, and continues tracking at its `next_frame`
    (frames must be the SAME full sequence; SURVEY §5.3 recovery model).

    `features`: pre-extracted `parallel.sequence.SequenceFeatures` for the
    whole sequence (e.g. from data-parallel extraction over a mesh) — the
    loop then skips per-frame extraction and only dispatches match/PnP/BA.

    `ba_fn`: optional BAProblem -> BAState override for the windowed BA
    (e.g. `parallel.sequence.make_distributed_ba(mesh)` — BASELINE config 5's
    distributed Schur solve); defaults to the single-device `ba.run_ba`.

    `metrics`: a `pipeline.metrics.MetricsLogger` — per-frame tracking,
    keyframe, and BA-window JSONL events (SURVEY §5.5).

    `checkpoint_path`: periodic crash-recovery snapshots (SURVEY §5.3) —
    after every keyframe's windowed BA the map/trajectory state is written
    atomically to this path; a killed run restarts via
    `run_slam(..., resume=checkpoint.load_slam_state(path))`.

    `pg_fn`: optional pose-graph optimizer override for ONLINE loop
    corrections, callable (Sim3PoseGraph, iters, n_fix) -> (graph, costs)
    (`n_fix` = number of leading keyframes to freeze) — e.g. the
    edge-sharded distributed solver (config 5); defaults to the
    single-device dense/CG auto-select in `apply_pose_graph_sim3`."""
    import jax.numpy as jnp

    from .metrics import or_null

    metrics = or_null(metrics)

    from ..frontend.extract import extract_features_jit
    from ..frontend.match import match_descriptors
    from ..geometry import epipolar, pose as P
    from ..optim import ba, pnp

    intr_j = jnp.asarray(intr, jnp.float32)
    fxy = np.asarray(intr[:2])
    cxy = np.asarray(intr[2:])
    T = len(frames)
    M = scfg.max_map_points

    map_X = np.zeros((M, 3), np.float32)
    map_mask = np.zeros(M, bool)
    map_anchor = np.full(M, -1, np.int32)  # anchor KF index per map slot
    map_n = 0

    keyframes: List[Keyframe] = []
    # device-resident loop-closure archive cache (see detect_loop)
    arch_cache = {"cand": (), "C": 0, "d": None, "m": None}
    # odometry measurement store: (kf_a, kf_b) -> rel_sim7, recorded (and
    # refreshed while both endpoints share a BA window) at windowed-BA time
    odo_store: dict = {}
    traj = np.zeros((T, 6), np.float32)
    tracked: List[int] = []
    vel = np.zeros(6, np.float32)  # constant-velocity tracker state
    loop_edges: List[tuple] = []   # measured (kf_i, kf_j, rel_sim3, weight)
    # loop-closure archive: when a keyframe's device buffers retire, its
    # descriptors drop to a HOST copy stored on the keyframe itself
    # (kp["desc_host"]) — host RAM is the right home for the revisit
    # database, and riding on the Keyframe means checkpoints persist it
    # (a resumed run can still close loops against pre-checkpoint keyframes)

    def extract(t):
        if features is not None:
            return features.frame_feats(t)
        return extract_features_jit(jnp.asarray(frames[t][None]), cfg)

    def host_kp(t, ft):
        """Host copies of frame t's keypoints without a device pull when the
        sequence was pre-extracted (features.x/y/mask already host-side)."""
        if features is not None:
            return dict(x=features.x[t], y=features.y[t],
                        desc=ft.desc[0], mask=features.mask[t])
        return _host_kp(ft)

    def match(fa, fb):
        res = match_descriptors(fa.desc[0], fb.desc[0], fa.mask[0], fb.mask[0], mcfg)
        c = int(res.count)
        return np.asarray(res.pairs[:c])

    def normalized(kp, idx):
        uv = np.stack([kp["x"][idx], kp["y"][idx]], 1)
        return (uv - cxy) / fxy, uv

    def rt(tw):
        R, t = P.exp_se3(jnp.asarray(tw))
        return np.asarray(R), np.asarray(t)

    def triangulate_pairs(kf: Keyframe, cur_kp, cur_pose, pairs):
        """Triangulate KF<->current matches; returns world points + accept mask."""
        Rk, tk = rt(kf.pose)
        Rc, tc = rt(cur_pose)
        x0n, _ = normalized(kf.kp, pairs[:, 0])
        x1n, _ = normalized(cur_kp, pairs[:, 1])
        X = np.asarray(P.triangulate(
            jnp.asarray(Rk, jnp.float32), jnp.asarray(tk, jnp.float32),
            jnp.asarray(Rc, jnp.float32), jnp.asarray(tc, jnp.float32),
            jnp.asarray(x0n, jnp.float32), jnp.asarray(x1n, jnp.float32),
        ))
        zk = X @ Rk.T + tk
        zc = X @ Rc.T + tc
        ok = (zk[:, 2] > scfg.min_depth) & (zc[:, 2] > scfg.min_depth)
        ok &= (zk[:, 2] < scfg.max_depth) & (zc[:, 2] < scfg.max_depth)
        for (R_, t_, kp_, col) in ((Rk, tk, kf.kp, 0), (Rc, tc, cur_kp, 1)):
            pr = X @ R_.T + t_
            pr = fxy * pr[:, :2] / np.maximum(pr[:, 2:], 1e-9) + cxy
            uv = np.stack([kp_["x"][pairs[:, col]], kp_["y"][pairs[:, col]]], 1)
            ok &= np.linalg.norm(pr - uv, axis=1) < scfg.tri_reproj_px
        return X, ok

    def _record_odo():
        """Record/refresh odometry MEASUREMENTS (consecutive + skip-1 pairs)
        among the keyframes the BA window (+ bridging retired neighbor) can
        still move.  One batched dispatch; values stay fixed once both
        endpoints retire, so later pose-graph corrections never rewrite the
        measurements they are balanced against."""
        from ..optim.pose_graph import srt_to_sim7

        hi = len(keyframes)
        lo = max(0, hi - scfg.kf_window - 1)
        pairs = []
        for a in range(lo, hi - 1):
            for b in (a + 1, a + 2):
                if b < hi:
                    pairs.append((a, b))
        if not pairs:
            return
        pa = jnp.asarray(np.stack([keyframes[a].pose for a, _ in pairs]))
        pb = jnp.asarray(np.stack([keyframes[b].pose for _, b in pairs]))
        Ra, ta = P.exp_se3(pa)
        Rb, tb = P.exp_se3(pb)
        Rr, tr_ = P.relative(Ra, ta, Rb, tb)
        rel = np.asarray(
            srt_to_sim7(jnp.ones(len(pairs)), Rr, tr_), np.float32
        )
        for n_, ab in enumerate(pairs):
            odo_store[ab] = rel[n_]

    def windowed_ba():
        nonlocal map_X
        win = keyframes[-scfg.kf_window:]
        cams = jnp.asarray(np.stack([k.pose for k in win]))
        obs_c, obs_p, obs_uv = [], [], []
        for ci, k in enumerate(win):
            sel = np.nonzero(k.pt_ids >= 0)[0]
            obs_c += [ci] * len(sel)
            obs_p += list(k.pt_ids[sel])
            obs_uv += list(np.stack([k.kp["x"][sel], k.kp["y"][sel]], 1))
        if len(obs_c) < 10:
            return
        # landmarks whose anchor keyframe retired are FIXED: the window's
        # observations of them constrain the cameras (revisit anchoring)
        # but cannot drag established geometry toward the recent window —
        # the corruption channel that starved loop detection after an
        # online fusion (see BAProblem.pt_fixed)
        base = len(keyframes) - len(win)
        if ba_fn is not None and getattr(ba_fn, "resident", False):
            # shard-resident map blocks (parallel/resident_ba.py): the
            # solver owns the device-partitioned point store across
            # windows — no full-map upload here, only the observation
            # lists and host-dirty slots travel
            if not getattr(ba_fn, "_intr_bound", False):
                ba_fn.set_intrinsics(np.asarray(intr_j))
                ba_fn._intr_bound = True
            new_cams, cost = ba_fn.solve(
                np.stack([k.pose for k in win]), obs_c, obs_p,
                np.stack(obs_uv), np.asarray(map_anchor < base), map_X,
                scfg.ba_iters, scfg.ba_cg,
            )
            for ci, k in enumerate(win):
                k.pose = new_cams[ci]
                traj[k.frame_idx] = new_cams[ci]
            _record_odo()
            metrics.event("ba_window", n_kf=len(win), n_obs=len(obs_c),
                          cost=cost)
            return
        prob = ba.BAProblem(
            cams=cams,
            points=jnp.asarray(map_X),
            intrinsics=intr_j,
            cam_idx=jnp.asarray(obs_c, jnp.int32),
            pt_idx=jnp.asarray(obs_p, jnp.int32),
            uv=jnp.asarray(np.stack(obs_uv), jnp.float32),
            w=jnp.ones(len(obs_c), jnp.float32),
            pt_fixed=jnp.asarray(map_anchor < base),
        )
        if ba_fn is not None:  # e.g. the distributed Schur solve (config 5)
            state = ba_fn(prob, scfg.ba_iters, scfg.ba_cg)
        else:
            state = ba.run_ba(prob, iters=scfg.ba_iters, n_cg=scfg.ba_cg)
        new_cams = np.asarray(state.cams)
        for ci, k in enumerate(win):
            k.pose = new_cams[ci]
            traj[k.frame_idx] = new_cams[ci]
        map_X = np.array(state.points)  # copy: np.asarray of a jax array is read-only
        _record_odo()
        metrics.event("ba_window", n_kf=len(win), n_obs=len(obs_c),
                      cost=float(np.asarray(state.cost)))

    def add_keyframe(t, feats, kp, pose_tw, mapped_pairs=None, prev_kf=None,
                     tri_pairs=None):
        nonlocal map_n, map_X, map_mask
        K = len(kp["x"])
        pt_ids = np.full(K, -1, np.int64)
        if mapped_pairs is not None:
            for mp, ki in mapped_pairs:
                pt_ids[ki] = mp
        kf = Keyframe(frame_idx=t, pose=np.asarray(pose_tw, np.float32),
                      feats=feats, kp=kp, pt_ids=pt_ids)
        # triangulate unmapped matches against the previous keyframe
        if prev_kf is not None and tri_pairs is not None and len(tri_pairs):
            X, ok = triangulate_pairs(prev_kf, kp, kf.pose, tri_pairs)
            for j in np.nonzero(ok)[0]:
                if map_n >= M:
                    break
                s = map_n
                map_X[s] = X[j]
                map_mask[s] = True
                # anchor = the inserting keyframe (index it takes on append):
                # loop corrections move the point with this keyframe
                map_anchor[s] = len(keyframes)
                map_n += 1
                prev_kf.pt_ids[tri_pairs[j, 0]] = s
                kf.pt_ids[tri_pairs[j, 1]] = s
        keyframes.append(kf)
        # the new keyframe's odometry edges must exist BEFORE detect_loop
        # runs (an online correction's graph needs its last node tied to the
        # chain); refreshed post-BA by windowed_ba
        _record_odo()
        # retire device buffers of keyframes no longer matched against (only
        # the last two are): HBM stays flat over arbitrarily long runs
        # (VERDICT r1 weak #1); host copies (x, y, pt_ids) remain for BA.
        # Retiring descriptors drop to the host-side loop-closure archive.
        for old in keyframes[:-2]:
            if old.feats is not None:
                if scfg.loop_closure and old.kp.get("desc") is not None:
                    old.kp["desc_host"] = np.asarray(old.kp["desc"])
                old.feats = None
                old.kp["desc"] = None
        if scfg.loop_closure:
            detect_loop(kf)
        return kf

    def _archive_match(cur_desc, cur_mask):
        """ONE batched match dispatch of the given descriptors against ALL
        archived (retired) keyframes through the device-resident cache.
        Shared by loop detection and relocalization (the latter is the
        same machinery with different eligibility/verification, VERDICT r4
        task 3).  Returns (cand, pairs_np, counts_np) or None."""
        cand = sorted(
            i for i, k in enumerate(keyframes)
            if k.kp.get("desc_host") is not None
        )
        if not cand:
            return None
        d0 = keyframes[cand[0]].kp["desc_host"]
        C = 1
        while C < len(cand):
            C *= 2  # capacity bucket: stable shapes -> few recompiles
        # device-resident archive cache: entries are immutable, and the
        # candidate list only ever APPENDS (keyframes retire in order) —
        # so re-upload only the new rows, and the full host->device
        # transfer only on capacity growth (ADVICE r3 #3: the
        # rebuild-every-insertion upload grew with the archive)
        if (C != arch_cache["C"]
                or tuple(cand[: len(arch_cache["cand"])]) != arch_cache["cand"]):
            arch_d = np.zeros((C,) + d0.shape, d0.dtype)
            arch_m = np.zeros((C, d0.shape[0]), bool)
            for s, i in enumerate(cand):
                arch_d[s] = keyframes[i].kp["desc_host"]
                arch_m[s] = np.asarray(keyframes[i].kp["mask"])
            d_dev = jnp.asarray(arch_d)
            m_dev = jnp.asarray(arch_m)
        else:
            d_dev, m_dev = arch_cache["d"], arch_cache["m"]
            for s in range(len(arch_cache["cand"]), len(cand)):
                i = cand[s]
                d_dev = d_dev.at[s].set(
                    jnp.asarray(keyframes[i].kp["desc_host"]))
                m_dev = m_dev.at[s].set(
                    jnp.asarray(np.asarray(keyframes[i].kp["mask"])))
        arch_cache.update(cand=tuple(cand), C=C, d=d_dev, m=m_dev)
        pairs_d, counts_d = _loop_match_jit(
            d_dev, m_dev, cur_desc, jnp.asarray(cur_mask), mcfg,
        )
        pairs_np, counts_np = jax.device_get((pairs_d, counts_d))
        return cand, pairs_np, counts_np[: len(cand)]

    def detect_loop(kf: Keyframe):
        """Revisit detection for the just-inserted keyframe (SURVEY §7.2
        step 9): one batched match dispatch against every archived keyframe,
        PnP of the best candidate's MAP points against the new keyframe's
        observations, and a measured relative-pose loop edge on success.
        The PnP runs in the old region's (pre-drift) frame, so the edge
        carries exactly the information windowed BA lost."""
        n_new = len(keyframes) - 1
        am = _archive_match(kf.kp["desc"], kf.kp["mask"])
        if am is None:
            return
        cand, pairs_np, counts_np = am
        # eligibility gates (temporal separation) applied AFTER the match:
        # candidates are matched independently, so the best eligible pick
        # is identical to the pre-filtered form — and the archive cache is
        # shared with the relocalizer, which has no gates
        elig = [
            s for s, i in enumerate(cand)
            if n_new - i >= scfg.loop_kf_gap
            and kf.frame_idx - keyframes[i].frame_idx >= scfg.loop_min_frame_gap
        ]
        if not elig:
            return
        c = max(elig, key=lambda s: counts_np[s])
        if counts_np[c] < scfg.loop_min_matches:
            return
        old = keyframes[cand[c]]
        pr = pairs_np[c][: counts_np[c]]
        has3d = old.pt_ids[pr[:, 0]] >= 0
        p3 = pr[has3d]
        if len(p3) < scfg.loop_min_inliers:
            return
        slots = old.pt_ids[p3[:, 0]]
        # CURRENT map coordinates, deliberately: retirement-time landmark
        # snapshots were tried (VERDICT r3 task 8) and REJECTED with
        # evidence — a snapshot freezes the old side in the frame of its
        # era (on the loop fixture: bootstrap-era scale 4.5 vs 2.6 by
        # mid-run after early BA rescaling), while the pose-graph nodes are
        # the CURRENT estimates, so snapshot-frame edges measured a fake
        # 0.48x "scale drift" that the trajectory's flat step-length
        # profile refutes.  The dual-PnP relative measure below is immune
        # to coherent point drift (both cameras solve against the SAME
        # set), and the scale ratio is measured current-vs-current.
        X = jnp.asarray(map_X[slots])
        w1 = jnp.ones(len(slots), jnp.float32)
        # Relative pose from TWO PnP solves against the SAME map points —
        # the old keyframe's and the new keyframe's 2D observations of them.
        # Windowed BA keeps dragging old points to fit the (drifted) recent
        # window, so a single PnP vs the stored old POSE measures point
        # drift, not camera revisit geometry; solving both cameras against
        # one common point set cancels the point drift in the relative
        # measure.  Full-strength GN (>= 10 iters) regardless of how cheap
        # the tracking loop's PnP was configured — this edge's accuracy
        # bounds what the pose graph can recover.
        it = max(scfg.pnp_iters, 10)
        uv_old = np.stack([old.kp["x"][p3[:, 0]], old.kp["y"][p3[:, 0]]], 1)
        uv_new = np.stack([kf.kp["x"][p3[:, 1]], kf.kp["y"][p3[:, 1]]], 1)
        res_o = pnp.pnp_gn(
            X, jnp.asarray(uv_old, jnp.float32), w1, intr_j,
            jnp.asarray(old.pose), iters=it,
            huber_px=scfg.huber_px, inlier_px=scfg.inlier_px,
        )
        res_n = pnp.pnp_gn(
            X, jnp.asarray(uv_new, jnp.float32), w1, intr_j,
            jnp.asarray(kf.pose), iters=it,
            huber_px=scfg.huber_px, inlier_px=scfg.inlier_px,
        )
        n_inl = min(int(res_o.num_inliers), int(res_n.num_inliers))
        # absolute floor AND majority-inlier gate: a pose that explains only
        # a minority of the 3D matches is a mis-registration, and one bad
        # measured edge corrupts the whole pose graph
        if n_inl < scfg.loop_min_inliers or n_inl < 0.5 * len(p3):
            return
        # --- Sim(3) edge measurement (monocular scale drift) ---
        # The SE(3) part always comes from the dual PnP (relative pose from
        # two 2D-3D solves against the SAME snapshot point set — point drift
        # cancels, and reprojection constraints are far more accurate than
        # monocular 3D structure).  Full 3D-3D Umeyama registration was
        # tried and REJECTED: triangulated monocular depths carry 20-50%
        # noise, and the fitted rotation/translation came out with |t| up to
        # 25x ground truth on the loop-scene fixture.  The SCALE component
        # only needs the radial-spread ratio of the two camera-local clouds
        # of the same physical points — a rotation/translation-invariant,
        # median-robust scalar.
        #
        # Chart derivation: cam_j's local frame is the drifted-scale frame
        # x_local = s_rel * x_true, so its consistent Sim(3) node (in the
        # old-scale world) is (s_rel, R_j, s_rel t_j) and the measured edge
        # S_j o S_i^-1 = (s_rel, Rr, s_rel tr) with (Rr, tr) the dual-PnP
        # SE(3) relative.
        new_ids = kf.pt_ids[p3[:, 1]]
        # only DUAL-PnP-INLIER matches feed the scale measurement and the
        # landmark fusion: an outlier association has arbitrary 3D geometry
        # and fusing one would weld unrelated landmarks together
        inl_both = np.asarray(res_o.inliers) & np.asarray(res_n.inliers)
        both = (new_ids >= 0) & inl_both
        # ... and only MATURE new-side landmarks (not triangulated by THIS
        # keyframe): fresh 2-view triangulations carry systematic depth
        # error, and a wrong depth scales depth AND lateral offset together
        # — on the loop fixture they faked a 0.56x "scale drift" that the
        # trajectory's true step-length profile (~constant) refutes.
        # DISTINCT slots only: when tracking re-associated the old landmark
        # (old slot == new slot) there is no duplicated geometry and the
        # pair carries no scale information (its ratio is identically 1)
        mature = map_anchor[np.maximum(new_ids, 0)] < (len(keyframes) - 1)
        both_m = both & mature & (old.pt_ids[p3[:, 0]] != new_ids)
        Ro, to = P.exp_se3(res_o.pose)
        Rn, tn = P.exp_se3(res_n.pose)
        Rr, tr_ = P.relative(Ro, to, Rn, tn)
        s_rel = 1.0
        if scfg.loop_sim3_scale and both_m.sum() >= 8:
            # both sides from the CURRENT map (see the snapshot rationale
            # above): s_rel = scale of j's local geometry relative to i's
            # local geometry AS CURRENTLY ESTIMATED — the quantity the
            # graph's node scales (initialized at 1) must absorb
            Xo = map_X[old.pt_ids[p3[both_m, 0]]]
            Xn = map_X[new_ids[both_m]]
            Ro_m = np.asarray(Ro)
            to_m = np.asarray(to)
            Rn_c, tn_c = rt(kf.pose)
            Y_old = Xo @ Ro_m.T + to_m      # in old cam, old-region scale
            Y_new = Xn @ Rn_c.T + tn_c      # in new cam, new-region scale
            # pairwise-distance ratio: rotation/translation-invariant and
            # exact for a similarity, median-robust to stragglers (the
            # centroid-radial variant is unstable for points near the
            # centroid)
            ratios = []
            for sh in (1, 2, 3):
                d_o = np.linalg.norm(Y_old - np.roll(Y_old, sh, 0), axis=1)
                d_n = np.linalg.norm(Y_new - np.roll(Y_new, sh, 0), axis=1)
                okp = d_o > 1e-6
                ratios.append(d_n[okp] / d_o[okp])
            ratios = np.concatenate(ratios)
            if len(ratios) >= 8:
                s_m = float(np.median(ratios))
                q25, q75 = np.quantile(ratios, [0.25, 0.75])
                # consistency gate: a real similarity relation gives a TIGHT
                # ratio distribution (measured: genuine ~[0.96, 1.02]);
                # noise-dominated new-side 3D gives a wide one (a bogus
                # 0.39 "drift" came with [0.37, 0.68] — applying it online
                # poisoned every later revisit).  Plus a sanity clamp:
                # within-sequence monocular drift beyond 2x is a
                # mis-association, not drift.
                if (q75 <= 1.35 * max(q25, 1e-9)
                        and 0.5 <= s_m <= 2.0):
                    s_rel = s_m
        rel7 = np.zeros(7, np.float32)
        rel7[:3] = np.asarray(P.log_so3(Rr), np.float32)
        rel7[3:6] = s_rel * np.asarray(tr_, np.float32)
        rel7[6] = np.log(s_rel)
        # duplicated-landmark correspondence the revisit match identified:
        # the same physical point in an old slot AND a fresh slot
        fo = old.pt_ids[p3[both, 0]]
        fn_ = new_ids[both]
        keep_f = fo != fn_
        fuse_pairs = np.stack([fo[keep_f], fn_[keep_f]], 1).astype(np.int64)
        loop_edges.append((cand[c], n_new, rel7, float(n_inl), fuse_pairs))
        metrics.event("loop_closure", kf_i=cand[c], kf_j=n_new,
                      matches=int(counts_np[c]), inliers=n_inl,
                      rel_scale=float(np.exp(rel7[6])))
        # ONLINE correction: correct keyframes + trajectory prefix + map and
        # fuse the duplicates NOW, so tracking continues on the corrected
        # state instead of drifting against a stale map for the rest of the
        # sequence (VERDICT r3 task 5).  Only STRONG edges fire online —
        # a marginal edge applied immediately with nothing to balance it
        # can corrupt the state and poison every later revisit (see
        # loop_online_min_inliers); weak edges wait for the end-of-run
        # refinement where the full edge set constrains the graph.
        # drift significance: measured loop translation vs the current
        # estimate's relative, in units of the median recent keyframe step
        Ri_c, ti_c = rt(old.pose)
        Rj_c, tj_c = rt(kf.pose)
        tr_cur = tj_c - (Rj_c @ Ri_c.T) @ ti_c
        disc = float(np.linalg.norm(rel7[3:6] - tr_cur))
        lastp = jnp.asarray(np.stack([k.pose for k in keyframes[-8:]]))
        Rl, tl = P.exp_se3(lastp)
        ctrs = -np.einsum("mji,mj->mi", np.asarray(Rl), np.asarray(tl))
        steps = np.linalg.norm(np.diff(ctrs, axis=0), axis=1)
        step_med = float(np.median(steps)) if len(steps) else 0.0
        significant = disc > scfg.loop_online_min_drift * max(step_med, 1e-9)
        if (scfg.loop_online and significant
                and n_inl >= scfg.loop_online_min_inliers):
            free = max(scfg.loop_online_free_kfs, scfg.kf_window)
            if apply_pose_graph_sim3(
                keyframes, traj, map_X, map_mask, map_anchor, loop_edges,
                optimizer=pg_fn, upto_frame=kf.frame_idx,
                fuse=scfg.loop_fuse,
                odo_edges=[(a, b, r) for (a, b), r in odo_store.items()],
                n_fix=max(1, len(keyframes) - free),
            ):
                # the constant-velocity state is expressed in the
                # pre-correction frame — reset it rather than extrapolate
                # a stale twist from the corrected pose
                vel[:] = 0.0
                # restore map consistency: anchor transport is exact per
                # anchor but slightly non-rigid across anchor boundaries;
                # a points-only Huber refit against the (pinned) corrected
                # poses removes the residual before tracking resumes
                refit_map_points(keyframes, map_X, map_mask, intr)
                metrics.event("loop_correction", kf_j=n_new,
                              n_kf=len(keyframes))

    def relocalize(kpt):
        """Re-register a LOST frame against the archived keyframe database
        (VERDICT r4 task 3: the detect_loop machinery refactored into a
        relocalizer): one batched archive match, then PnP of the best
        candidates' map points SEEDED FROM THE CANDIDATE KEYFRAME'S POSE —
        robust to arbitrary displacement from the pre-loss pose, which the
        live-KF tracking path (seeded from the stale last pose) is not.
        Returns (pose, keyframe, inliers) or None."""
        am = _archive_match(kpt["desc"], kpt["mask"])
        if am is None:
            return None
        cand, pairs_np, counts_np = am
        for c in np.argsort(counts_np)[::-1][:3]:
            if counts_np[c] < scfg.reloc_min_matches:
                break
            old = keyframes[cand[c]]
            pr = pairs_np[c][: counts_np[c]]
            has3d = old.pt_ids[pr[:, 0]] >= 0
            p3 = pr[has3d]
            if len(p3) < scfg.reloc_min_inliers:
                continue
            slots = old.pt_ids[p3[:, 0]]
            uv = np.stack([kpt["x"][p3[:, 1]], kpt["y"][p3[:, 1]]], 1)
            res = pnp.pnp_gn(
                jnp.asarray(map_X[slots]), jnp.asarray(uv, jnp.float32),
                jnp.ones(len(slots), jnp.float32), intr_j,
                jnp.asarray(old.pose), iters=max(scfg.pnp_iters, 10),
                huber_px=scfg.huber_px, inlier_px=scfg.inlier_px,
            )
            n_inl = int(res.num_inliers)
            # absolute floor AND majority gate, as for loop edges: a pose
            # explaining a minority of its 3D matches is a mis-registration
            if n_inl >= scfg.reloc_min_inliers and n_inl >= 0.5 * len(p3):
                return np.asarray(res.pose, np.float32), old, n_inl
        return None

    def _live_desc(k):
        return (k.feats.desc[0] if k.feats is not None
                else jnp.asarray(k.kp["desc_host"]))

    def _live_mask(k):
        return (k.feats.mask[0] if k.feats is not None
                else jnp.asarray(np.asarray(k.kp["mask"])))

    def track_loop(t0: int, last_pose: np.ndarray) -> int:
        """PnP tracking from frame t0 (constant-velocity twist model).

        Per frame: ONE fused extract+dual-match dispatch (`_track_step_jit`)
        followed by ONE batched host transfer of everything the bookkeeping
        needs — not per-array syncs (VERDICT r1 weak #1).

        Pipeline-parallel overlap (the extract(t+1) || match/PnP(t) analog,
        SURVEY §2.3 PP row ⚠ `MultiThreadSIFT`/server overlap): frame t+1's
        fused dispatch is enqueued speculatively against the CURRENT
        keyframes before frame t's results are pulled, so the device
        extracts t+1 while the host runs PnP/bookkeeping for t.  The
        speculation is invalidated (and t+1 re-dispatched) only when frame t
        inserts a new keyframe — outputs are bit-identical to the
        sequential loop."""
        nonlocal vel
        t = t0
        # speculative dispatch against the current kf_stack: live path
        # stores (frame, (feats, pairs, counts)); pre-extracted path stores
        # (frame, feats, (pairs, counts))
        pending = None
        kf_stack = None  # (token, d_kf, m_kf) — rebuilt on live-set change
        reloc_pair = None  # [archived KF, last KF] after archive reloc
        lost = False
        while t < T:
            # live matching set: normally the last two keyframes; after an
            # archive relocalization the matched (possibly retired) keyframe
            # takes the primary slot until the next insertion, so tracking
            # continues against geometry that actually sees the current view
            live = (reloc_pair if reloc_pair is not None
                    else keyframes[-2:][::-1])   # [-1] first, then [-2]
            kf = live[0]
            token = (len(keyframes), id(kf))
            if kf_stack is None or kf_stack[0] != token:
                kf_stack = (
                    token,
                    jnp.stack([_live_desc(k) for k in live]),
                    jnp.stack([_live_mask(k) for k in live]),
                )
            _, d_kf, m_kf = kf_stack
            if features is None:
                if pending is not None and pending[0] == t:
                    ft, pairs_dev, counts_dev = pending[1]
                else:
                    ft, pairs_dev, counts_dev = _track_step_jit(
                        jnp.asarray(frames[t]), d_kf, m_kf, cfg, mcfg
                    )
                if t + 1 < T:
                    pending = (t + 1, _track_step_jit(
                        jnp.asarray(frames[t + 1]), d_kf, m_kf, cfg, mcfg
                    ))
                # one host pull of pairs/counts/coords/mask (desc stays on device)
                pairs_np, counts_np, kx, ky, km = jax.device_get(
                    (pairs_dev, counts_dev, ft.x[0], ft.y[0], ft.mask[0])
                )
                kpt = dict(x=kx, y=ky, desc=ft.desc[0], mask=km)
            else:  # pre-extracted sequence: match-only dispatch
                if pending is not None and pending[0] == t:
                    # reuse the speculatively-fetched features too (in
                    # host-resident store mode `extract` re-uploads
                    # descriptors — don't pay that twice per frame)
                    ft, (pairs_dev, counts_dev) = pending[1], pending[2]
                else:
                    ft = extract(t)
                    pairs_dev, counts_dev = _match_kf_jit(
                        d_kf, m_kf, ft.desc[0], ft.mask[0], mcfg
                    )
                # speculative depth-1 pipelining (same rule as the live
                # path): enqueue frame t+1's match against the CURRENT
                # keyframes before blocking on frame t's pull, so the device
                # matches t+1 while the host runs PnP/bookkeeping for t;
                # invalidated on keyframe insertion (VERDICT r2 missing #3)
                if t + 1 < T:
                    ft1 = extract(t + 1)
                    pending = (t + 1, ft1, _match_kf_jit(
                        d_kf, m_kf, ft1.desc[0], ft1.mask[0], mcfg
                    ))
                # the ONE blocking transfer for this frame
                pairs_np, counts_np = jax.device_get((pairs_dev, counts_dev))
                kpt = host_kp(t, ft)
            pairs = pairs_np[0][: counts_np[0]]
            # 2D-3D correspondences through the keyframe's map ids
            has_map = (
                kf.pt_ids[pairs[:, 0]] >= 0 if len(pairs) else np.zeros(0, bool)
            )
            p3d = pairs[has_map] if len(pairs) else pairs
            slots = kf.pt_ids[p3d[:, 0]] if len(p3d) else np.zeros(0, np.int64)
            kp_idx = p3d[:, 1] if len(p3d) else np.zeros(0, np.int64)
            # widen the 2D-3D set with the previous keyframe's map points
            # (keyframe churn otherwise starves PnP right after insertion)
            if len(live) >= 2:
                kf2 = live[1]
                pairs2 = pairs_np[1][: counts_np[1]]
                if len(pairs2):
                    hm2 = kf2.pt_ids[pairs2[:, 0]] >= 0
                    p2 = pairs2[hm2]
                    new = ~np.isin(p2[:, 1], kp_idx)
                    slots = np.concatenate([slots, kf2.pt_ids[p2[new, 0]]])
                    kp_idx = np.concatenate([kp_idx, p2[new, 1]])
            pose_guess = last_pose + vel
            if len(slots) >= 6:
                uv = np.stack([kpt["x"][kp_idx], kpt["y"][kp_idx]], 1)
                res = pnp.pnp_gn(
                    jnp.asarray(map_X[slots]), jnp.asarray(uv, jnp.float32),
                    jnp.ones(len(slots), jnp.float32), intr_j,
                    jnp.asarray(pose_guess), iters=scfg.pnp_iters,
                    huber_px=scfg.huber_px, inlier_px=scfg.inlier_px,
                )
                pose_t = np.asarray(res.pose, np.float32)
                n_inl = int(res.num_inliers)
                inl = np.asarray(res.inliers)
            else:
                pose_t = pose_guess
                n_inl = 0
                inl = np.zeros(len(slots), bool)

            # --- tracking-loss state machine (VERDICT r4 task 3) ---
            tracking_ok = len(slots) >= 6 and n_inl >= scfg.lost_min_inliers
            if scfg.track_lost and not tracking_ok:
                if not lost:
                    lost = True
                    # the velocity model is meaningless across a loss —
                    # coasting on it walks the pose guess off to garbage
                    vel[:] = 0.0
                    metrics.event("track_lost", frame=t, inliers=n_inl)
                rel = relocalize(kpt) if scfg.relocalize else None
                if rel is None:
                    # HOLD the last confident pose; insert no keyframe,
                    # triangulate nothing (the r4 trigger treated this
                    # failure as "scene moved" and poisoned the map)
                    traj[t] = last_pose
                    tracked.append(0)
                    metrics.event("track", frame=t, inliers=0,
                                  matches=int(counts_np[0]), map_pts=map_n)
                    t += 1
                    continue
                pose_t, old_kf, n_inl = rel
                lost = False
                traj[t] = pose_t
                last_pose = pose_t
                tracked.append(n_inl)
                metrics.event("relocalized", frame=t,
                              kf=int(old_kf.frame_idx), inliers=n_inl)
                if old_kf is not keyframes[-1]:
                    reloc_pair = [old_kf, keyframes[-1]]
                    pending = None  # speculation matched the stale live set
                t += 1
                continue
            if lost:
                # recovering from LOST through live-KF matching.  The live
                # evidence can be thin exactly here (the camera may have
                # re-emerged far from the last keyframes' view, where a
                # 20-inlier PnP against a drifted local map mis-registers),
                # so compare it against the archive relocalizer and
                # re-register on the STRONGER evidence.
                rel = relocalize(kpt) if scfg.relocalize else None
                if rel is not None and rel[2] > n_inl:
                    pose_t, old_kf, n_inl = rel
                    lost = False
                    vel[:] = 0.0
                    traj[t] = pose_t
                    last_pose = pose_t
                    tracked.append(n_inl)
                    metrics.event("relocalized", frame=t,
                                  kf=int(old_kf.frame_idx), inliers=n_inl)
                    if old_kf is not keyframes[-1]:
                        reloc_pair = [old_kf, keyframes[-1]]
                        pending = None
                    # the frame's match/flow state is relative to the OLD
                    # live set — defer keyframe decisions to the next frame
                    t += 1
                    continue
                metrics.event("track_recovered", frame=t, inliers=n_inl)
                lost = False
                # (pose_t - last_pose) spans the whole loss gap — restart
                # the velocity model instead of absorbing the jump
                vel[:] = 0.0
            else:
                vel = 0.5 * vel + 0.5 * (pose_t - last_pose)
            traj[t] = pose_t
            last_pose = pose_t
            tracked.append(n_inl)
            metrics.event("track", frame=t, inliers=n_inl,
                          matches=int(counts_np[0]), map_pts=map_n)

            flow = (
                np.median(np.hypot(
                    kpt["x"][pairs[:, 1]] - kf.kp["x"][pairs[:, 0]],
                    kpt["y"][pairs[:, 1]] - kf.kp["y"][pairs[:, 0]],
                )) if len(pairs) else np.inf
            )
            if n_inl < scfg.kf_min_inliers or flow > scfg.kf_flow_px:
                mapped = [
                    (slots[i], kp_idx[i]) for i in np.nonzero(inl)[0]
                ]
                mapped_kp = {int(k) for _, k in mapped}
                unmapped = pairs[~has_map] if len(pairs) else pairs
                if len(unmapped):
                    # don't re-triangulate keypoints already tied to the map
                    # through the second keyframe
                    keep = ~np.isin(unmapped[:, 1], list(mapped_kp) or [-1])
                    unmapped = unmapped[keep]
                add_keyframe(t, ft, kpt, pose_t, mapped_pairs=mapped,
                             prev_kf=kf, tri_pairs=unmapped)
                pending = None  # speculative t+1 matched stale keyframes
                reloc_pair = None  # back to the natural last-two live set
                metrics.event("keyframe", frame=t, n_kf=len(keyframes),
                              map_pts=map_n)
                windowed_ba()
                last_pose = keyframes[-1].pose
                if checkpoint_path is not None:
                    from . import checkpoint as _ckpt

                    # multi-process runs compute identical state on every
                    # process; only process 0 owns the snapshot file (the
                    # others racing the same atomic rename would be wasted
                    # IO at best)
                    if jax.process_index() == 0:
                        _ckpt.save_slam_state(
                            checkpoint_path, _result(t), next_frame=t + 1,
                            keyframes=keyframes, kf_window=scfg.kf_window,
                        )
                    metrics.event("checkpoint", frame=t)
            t += 1
        return t

    def _result(_t) -> SlamResult:
        return SlamResult(
            trajectory=traj,
            keyframe_indices=[k.frame_idx for k in keyframes],
            map_points=map_X, map_mask=map_mask,
            num_tracked=tracked, keyframes=keyframes,
            vel=vel.copy(), loop_edges=list(loop_edges),
            map_anchor=map_anchor, map_n=map_n,
            odo_edges=[(a, b, r) for (a, b), r in sorted(odo_store.items())],
        )

    if resume is not None:
        # restore map + trajectory prefix + the full windowed-BA keyframe
        # context (+ tracker velocity), skip bootstrap.  With a round-3
        # checkpoint the resumed run replays the uninterrupted run EXACTLY;
        # legacy (single-keyframe) checkpoints restore a reduced window.
        import types

        d = resume.data
        n0 = int(d["next_frame"])
        traj[: len(d["trajectory"])] = d["trajectory"][:T]
        for i, v in enumerate(d["num_tracked"][:n0]):
            tracked.append(int(v))
        map_X[:] = d["map_points"]
        map_mask[:] = d["map_mask"]
        # allocation high-water mark: landmark fusion frees slots BELOW it,
        # so mask.sum() would under-count and a resumed run would overwrite
        # live slots.  New checkpoints store it; legacy ones had no fusion,
        # where the highest-used-slot fallback equals the old mask.sum().
        if "map_n" in d:
            map_n = int(d["map_n"])
        else:
            used = np.nonzero(map_mask)[0]
            map_n = int(used[-1]) + 1 if len(used) else 0
        if "map_anchor" in d:
            map_anchor[: len(d["map_anchor"])] = d["map_anchor"]
        if "vel" in d:
            vel = np.asarray(d["vel"], np.float32).copy()
        if "loop_i" in d:
            f_off = d.get("loop_fuse_off")
            f_cat = d.get("loop_fuse_pairs")
            for n_, (i_, j_, r_, w_) in enumerate(zip(
                d["loop_i"], d["loop_j"], d["loop_rel"], d["loop_w"]
            )):
                fp = (
                    np.asarray(f_cat[f_off[n_]: f_off[n_ + 1]], np.int64)
                    if f_off is not None else np.zeros((0, 2), np.int64)
                )
                loop_edges.append(
                    (int(i_), int(j_), np.asarray(r_), float(w_), fp)
                )
        if "odo_i" in d:
            for a_, b_, r_ in zip(d["odo_i"], d["odo_j"], d["odo_rel"]):
                odo_store[(int(a_), int(b_))] = np.asarray(r_, np.float32)

        if "kfw_frame_idx" in d:
            win_idx = [int(i) for i in d["kfw_frame_idx"]]
            # retired keyframes (older than the window): stubs carrying
            # identity + pose; the loop-closure archive below re-attaches
            # their host descriptors/keypoints so revisit detection keeps
            # working across a resume
            for fi in [int(i) for i in d["keyframe_indices"]]:
                if fi not in win_idx:
                    keyframes.append(Keyframe(
                        frame_idx=fi, pose=traj[fi].copy(), feats=None,
                        kp=dict(desc=None), pt_ids=np.zeros(0, np.int64),
                    ))
            n_desc = int(d.get("kfw_n_desc", 2))
            nw = len(win_idx)
            for i, fi in enumerate(win_idx):
                di = i - (nw - n_desc)   # index into kfw_desc for live KFs
                desc = jnp.asarray(d["kfw_desc"][di]) if di >= 0 else None
                feats_shim = (
                    types.SimpleNamespace(
                        desc=desc[None],
                        mask=jnp.asarray(d["kfw_mask"][i])[None],
                    )
                    if desc is not None else None
                )
                keyframes.append(Keyframe(
                    frame_idx=fi, pose=d["kfw_pose"][i].copy(),
                    feats=feats_shim,
                    kp=dict(x=d["kfw_x"][i], y=d["kfw_y"][i],
                            desc=desc, mask=d["kfw_mask"][i]),
                    pt_ids=d["kfw_pt_ids"][i].copy(),
                ))
            # re-attach the loop-closure archive (retired keyframes' host
            # descriptors + keypoints) so revisit detection keeps working
            # against pre-checkpoint keyframes
            if "arch_pos" in d:
                for s, pos in enumerate(int(i) for i in d["arch_pos"]):
                    k = keyframes[pos]
                    k.kp["desc_host"] = d["arch_desc"][s]
                    k.kp["mask"] = d["arch_mask"][s]
                    k.kp["x"] = d["arch_x"][s]
                    k.kp["y"] = d["arch_y"][s]
                    if k.pt_ids.size == 0:
                        k.pt_ids = d["arch_pt_ids"][s].copy()
        else:  # legacy round-2 single-keyframe checkpoint
            feats_shim = types.SimpleNamespace(
                desc=jnp.asarray(d["kf_desc"])[None],
                mask=jnp.asarray(d["kf_mask"])[None],
            )
            keyframes.append(Keyframe(
                frame_idx=int(d["kf_frame_idx"]), pose=d["kf_pose"].copy(),
                feats=feats_shim,
                kp=dict(x=d["kf_x"], y=d["kf_y"],
                        desc=jnp.asarray(d["kf_desc"]), mask=d["kf_mask"]),
                pt_ids=d["kf_pt_ids"].copy(),
            ))
        if "map_anchor" not in d:
            # legacy (pre-round-4) checkpoint: synthesize landmark anchors so
            # windowed BA's retired-anchor freeze (pt_fixed = anchor < base)
            # does not permanently freeze the restored window's landmarks and
            # pose-graph map transport does not skip them (ADVICE r4 #2).
            # The true anchor (the inserting keyframe) is unrecoverable; the
            # EARLIEST restored observer is the adjacent approximation — the
            # inserter is that keyframe or its successor, so transport moves
            # the point with (a neighbor of) the keyframe that made it.
            for i_k, k in enumerate(keyframes):
                if k.pt_ids.size:
                    ids = k.pt_ids[k.pt_ids >= 0]
                    unset = ids[map_anchor[ids] < 0]
                    map_anchor[unset] = i_k
            # masked slots observed only by dropped retired keyframes: anchor
            # to the chain origin (stays frozen in windowed BA, transported
            # rigidly with the established chain by loop corrections)
            map_anchor[map_mask & (map_anchor < 0)] = 0
        return _result(track_loop(n0, traj[n0 - 1].copy()))

    # ---------------- bootstrap ----------------
    f0 = extract(0)
    kp0 = host_kp(0, f0)
    traj[0] = 0.0
    kf0 = add_keyframe(0, f0, kp0, np.zeros(6, np.float32))
    tracked.append(int(kp0["mask"].sum()))

    boot_done = False
    t = 1
    key = jax.random.PRNGKey(0)
    last_pose = np.zeros(6, np.float32)
    buffered = []   # pre-bootstrap frames, re-localized once the map exists
    while t < T and not boot_done:
        ft = extract(t)
        kpt = host_kp(t, ft)
        pairs = match(f0, ft)
        metrics.event("bootstrap", frame=t, matches=len(pairs))
        if len(pairs) < 16:
            traj[t] = last_pose
            tracked.append(0)
            buffered.append((t, ft, kpt))
            t += 1
            continue
        flow = np.hypot(
            kpt["x"][pairs[:, 1]] - kp0["x"][pairs[:, 0]],
            kpt["y"][pairs[:, 1]] - kp0["y"][pairs[:, 0]],
        )
        if np.median(flow) < scfg.init_flow_px:
            traj[t] = last_pose
            tracked.append(len(pairs))
            buffered.append((t, ft, kpt))
            t += 1
            continue
        # two-view initialization
        import jax.numpy as jnp

        x0n, _ = normalized(kp0, pairs[:, 0])
        x1n, _ = normalized(kpt, pairs[:, 1])
        f_mean = float(fxy.mean())
        rr = epipolar.ransac_essential(
            jnp.asarray(x0n, jnp.float32), jnp.asarray(x1n, jnp.float32),
            jnp.ones(len(pairs), bool), key,
            num_hypotheses=256, threshold=(2.0 / f_mean) ** 2,
        )
        tv = P.recover_pose(rr.E, jnp.asarray(x0n, jnp.float32),
                            jnp.asarray(x1n, jnp.float32), rr.inliers)
        pose_t = np.asarray(P.log_se3(tv.R, tv.t), np.float32)
        traj[t] = pose_t
        last_pose = pose_t
        kf1 = add_keyframe(t, ft, kpt, pose_t, prev_kf=kf0, tri_pairs=pairs)
        tracked.append(int(tv.num_good))
        windowed_ba()
        last_pose = keyframes[-1].pose
        boot_done = True
        t += 1

        # retroactively localize buffered pre-bootstrap frames with PnP
        # against the fresh map (through keyframe 0's keypoint->map ids)
        for (tb, fb, kpb) in buffered:
            bp = match(kf0.feats, fb)
            if not len(bp):
                continue
            hm = kf0.pt_ids[bp[:, 0]] >= 0
            b3 = bp[hm]
            if len(b3) < 6:
                continue
            slots = kf0.pt_ids[b3[:, 0]]
            uv = np.stack([kpb["x"][b3[:, 1]], kpb["y"][b3[:, 1]]], 1)
            resb = pnp.pnp_gn(
                jnp.asarray(map_X[slots]), jnp.asarray(uv, jnp.float32),
                jnp.ones(len(slots), jnp.float32), intr_j,
                jnp.zeros(6, jnp.float32), iters=scfg.pnp_iters,
                huber_px=scfg.huber_px, inlier_px=scfg.inlier_px,
            )
            traj[tb] = np.asarray(resb.pose, np.float32)
            tracked[tb] = int(resb.num_inliers)
        buffered.clear()

    # ---------------- tracking ----------------
    return _result(track_loop(t, last_pose))
