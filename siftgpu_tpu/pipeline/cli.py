"""CLI front end: the demo/app layer analog (SURVEY.md §2.2 ⚠).

Subcommands mirror the reference's demo binaries:
  extract   -> SimpleSIFT.cpp's extraction half (+ -o .sift output)
  match     -> SimpleSIFT.cpp's matching half (extract 2 images, match, print)
  speed     -> speed.cpp (repeat RunSIFT, report ms + Hz)
  twoview   -> two-view SfM (config 4): E, pose, BA rms
  slam      -> monocular SLAM over an image sequence (keyframes, windowed
               BA, loop closure); --traj writes a TUM-format trajectory
  dump      -> TestWinGlut viewer analog: write every pyramid stage
               (gaussian / DoG / gradient magnitude) as PGM files for
               inspection (§2.2 "GLUT viewer" row)

Reference extraction flags (-fo -d -t -e -m -s -maxd -tc -loweo -unn -b -v)
are accepted anywhere after the subcommand and forwarded to `parse_flags`.

Usage: python -m siftgpu_tpu <subcommand> [args...]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..core import image as imio
from ..core.flags import parse_flags
from .api import SiftMatchTPU, SiftTPU

__all__ = ["main"]


def _split_flags(args):
    """Separate known reference flags from argparse args."""
    known, rest = [], []
    i = 0
    from ..core.flags import _BOOL, _OPTIONAL_VALUED, _TC, _VALUED

    _valued = {**_VALUED, **dict.fromkeys(_TC)}
    while i < len(args):
        a = args[i]
        base = a.split("=")[0]
        if base in _valued and "=" not in a:
            known += args[i : i + 2]
            i += 2
        elif base in _valued or base in _BOOL:
            known.append(a)
            i += 1
        elif base in _OPTIONAL_VALUED:
            # same consume-iff-it-parses rule as core.flags.parse_flags
            # (accepts negatives), so CLI and API agree on -m/-s values
            nxt = args[i + 1] if i + 1 < len(args) else None
            consumed = False
            if nxt is not None and "=" not in a:
                try:
                    int(nxt)
                    consumed = True
                except ValueError:
                    pass
            if consumed:
                known += args[i : i + 2]
                i += 2
            else:
                known.append(a)
                i += 1
        else:
            rest.append(a)
            i += 1
    return known, rest


def cmd_extract(argv):
    flags_argv, rest = _split_flags(argv)
    p = argparse.ArgumentParser(prog="extract")
    p.add_argument("image")
    p.add_argument("--out", "-O", default=None)
    p.add_argument("--npz", default=None)
    a = p.parse_args(rest)
    s = SiftTPU(argv=flags_argv)
    t0 = time.perf_counter()
    s.run_sift(a.image)
    n = s.get_feature_num()
    print(f"{n} features  ({(time.perf_counter() - t0) * 1e3:.1f} ms incl. compile)")
    out = a.out or s._overrides.get("_output_file")
    if out:
        s.save_sift(out)
        print(f"wrote {out}")
    if a.npz:
        from . import siftio

        siftio.save_feature_store(a.npz, s._feats)
        print(f"wrote {a.npz}")
    return 0


def cmd_match(argv):
    flags_argv, rest = _split_flags(argv)
    p = argparse.ArgumentParser(prog="match")
    p.add_argument("image0")
    p.add_argument("image1")
    p.add_argument("--distmax", type=float, default=0.7)
    p.add_argument("--ratiomax", type=float, default=0.8)
    p.add_argument(
        "--viz", default=None, metavar="OUT.ppm",
        help="write a side-by-side match-lines overlay (viewer analog)",
    )
    a = p.parse_args(rest)
    s = SiftTPU(argv=flags_argv)
    s.run_sift(a.image0)
    k0, d0 = s.get_feature_vector()
    s.run_sift(a.image1)
    k1, d1 = s.get_feature_vector()
    m = SiftMatchTPU(max_sift=max(len(d0), len(d1), 1))
    m.set_descriptors(0, d0)
    m.set_descriptors(1, d1)
    pairs = m.get_sift_match(distmax=a.distmax, ratiomax=a.ratiomax)
    print(f"{len(d0)} x {len(d1)} features -> {len(pairs)} matches")
    for i, j in pairs[:20]:
        print(f"  ({k0[i,0]:7.2f},{k0[i,1]:7.2f}) <-> ({k1[j,0]:7.2f},{k1[j,1]:7.2f})")
    if a.viz:
        from . import viz

        img0 = imio.load_image(a.image0)
        img1 = imio.load_image(a.image1)
        imio.save_ppm(a.viz, viz.draw_matches(img0, img1, k0, k1, pairs))
        print(f"wrote {a.viz}")
    return 0


def cmd_speed(argv):
    flags_argv, rest = _split_flags(argv)
    p = argparse.ArgumentParser(prog="speed")
    p.add_argument("image")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument(
        "--trace", default=None, metavar="DIR",
        help="capture a jax.profiler trace (XProf/Perfetto) of the steady "
             "state into DIR (SURVEY §5.1); stages carry jax.named_scope "
             "annotations sift.{pyramid,detect,describe.octN,assemble}",
    )
    a = p.parse_args(rest)
    s = SiftTPU(argv=flags_argv)
    s.run_sift(a.image)  # warm-up / compile
    s.get_feature_num()  # device sync (dispatch is async)
    ctx = None
    if a.trace:
        import jax

        ctx = jax.profiler.trace(a.trace)
        ctx.__enter__()
    t0 = time.perf_counter()
    for _ in range(a.iters):
        s.run_sift(a.image)
        s.get_feature_num()  # per-iter sync: reads the count back
    dt = (time.perf_counter() - t0) / a.iters
    if ctx is not None:
        ctx.__exit__(None, None, None)
        print(f"trace written to {a.trace}")
    print(
        f"{s.get_feature_num()} features, {dt * 1e3:.2f} ms/frame, "
        f"{1.0 / dt:.1f} Hz (steady-state, {a.iters} iters)"
    )
    return 0


def cmd_twoview(argv):
    flags_argv, rest = _split_flags(argv)
    p = argparse.ArgumentParser(prog="twoview")
    p.add_argument("image0")
    p.add_argument("image1")
    p.add_argument("--focal", type=float, required=True)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(rest)
    import jax
    import jax.numpy as jnp

    from ..core.config import MatchConfig
    from . import twoview

    img0 = imio.load_image(a.image0)
    img1 = imio.load_image(a.image1)
    assert img0.shape == img1.shape
    s = SiftTPU(argv=flags_argv)
    maxd = s._overrides.get("max_dim", 0)
    if maxd:  # -maxd: downsample the frames, not just the config geometry
        img0 = imio.downsample_to_fit(img0, maxd)
        img1 = imio.downsample_to_fit(img1, maxd)
    H, W = img0.shape
    cfg = s.config_for(H, W)
    intr = jnp.asarray([a.focal, a.focal, W / 2.0, H / 2.0], jnp.float32)
    res = twoview.two_view_reconstruct(
        jnp.stack([jnp.asarray(img0), jnp.asarray(img1)]), intr,
        cfg, MatchConfig(max_match=cfg.max_keypoints), jax.random.PRNGKey(a.seed),
    )
    R = np.asarray(res.R)
    print(f"matches={int(res.num_matches)} inliers={int(res.num_inliers)}")
    print(f"R=\n{R}")
    print(f"t={np.asarray(res.t)}  rms={float(res.rms):.3f}px")
    return 0


def cmd_dump(argv):
    flags_argv, rest = _split_flags(argv)
    p = argparse.ArgumentParser(prog="dump")
    p.add_argument("image")
    p.add_argument("--outdir", default="dump")
    p.add_argument(
        "--kp", action="store_true",
        help="also render keypoints (scale circles + orientation ticks) "
             "over the input as keypoints.ppm (viewer analog)",
    )
    a = p.parse_args(rest)
    import os

    import jax.numpy as jnp

    from ..frontend import orient, pyramid

    os.makedirs(a.outdir, exist_ok=True)
    s = SiftTPU(argv=flags_argv)
    img = imio.load_image(a.image)
    maxd = s._overrides.get("max_dim", 0)
    if maxd:
        img = imio.downsample_to_fit(img, maxd)
    if a.kp:
        from . import viz

        s.run_sift(img)
        keys, _ = s.get_feature_vector()
        over = viz.draw_keypoints(
            img, keys[:, 0], keys[:, 1], keys[:, 2], keys[:, 3]
        )
        imio.save_ppm(f"{a.outdir}/keypoints.ppm", over)
        print(f"wrote {a.outdir}/keypoints.ppm ({len(keys)} keypoints)")
    cfg = s.config_for(*img.shape)
    pyr = pyramid.build_pyramid(jnp.asarray(img[None]), cfg)
    for o, oc in enumerate(pyr):
        g = np.asarray(oc.gauss[0])
        d = np.asarray(oc.dog[0])
        for l in range(g.shape[0]):
            imio.save_pgm(f"{a.outdir}/o{o}_gauss{l}.pgm", g[l])
        for l in range(d.shape[0]):
            dn = 0.5 + d[l] * 5.0
            imio.save_pgm(f"{a.outdir}/o{o}_dog{l}.pgm", np.clip(dn, 0, 1))
        gs = orient.gradient_stack(oc.gauss, cfg)
        mag = np.hypot(np.asarray(gs.gx[0], np.float32),
                       np.asarray(gs.gy[0], np.float32))
        for l in range(mag.shape[0]):
            imio.save_pgm(f"{a.outdir}/o{o}_gradmag{l}.pgm", np.clip(mag[l] * 4, 0, 1))
    print(f"wrote pyramid stages to {a.outdir}/")
    return 0


def cmd_serve(argv):
    """ServerSiftGPU analog: serve one SiftTPU+SiftMatchTPU over TCP.
    Flags after `--` are forwarded to the server's parse_param."""
    fwd = []
    if "--" in argv:
        i = argv.index("--")
        argv, fwd = argv[:i], argv[i + 1 :]
    p = argparse.ArgumentParser(prog="serve")
    p.add_argument("--port", type=int, default=7777)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-sift", type=int, default=4096)
    p.add_argument("--one-shot", action="store_true")
    a = p.parse_args(argv)
    from . import server

    server.serve(
        a.port, host=a.host, argv=fwd or None, max_sift=a.max_sift,
        one_shot=a.one_shot,
    )
    return 0


def cmd_slam(argv):
    """Monocular SLAM over an ordered image sequence (the north-star back
    end, BASELINE config 5's single-chip form): tracking + keyframes +
    windowed BA + loop closure; writes a TUM-format trajectory that the
    standard ATE/RPE evaluation tools consume."""
    flags_argv, rest = _split_flags(argv)
    p = argparse.ArgumentParser(prog="slam")
    p.add_argument("images", nargs="+",
                   help="image files in order, or ONE .npy of [T, H, W]")
    p.add_argument("--focal", type=float, required=True)
    p.add_argument("--traj", default=None,
                   help="write the trajectory here (TUM format)")
    p.add_argument("--checkpoint", default=None,
                   help="periodic crash-recovery snapshots (atomic NPZ)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint (exact replay)")
    p.add_argument("--metrics", default=None, help="JSONL metrics stream")
    p.add_argument("--kf-window", type=int, default=4)
    p.add_argument("--no-loop", action="store_true",
                   help="disable loop-closure detection")
    a = p.parse_args(rest)

    if len(a.images) == 1 and a.images[0].endswith(".npy"):
        frames = np.load(a.images[0])
        if frames.dtype == np.uint8:
            frames = frames.astype(np.float32) / 255.0
        frames = frames.astype(np.float32)
    else:
        frames = np.stack([imio.load_image(f) for f in a.images])
    T, H, W = frames.shape

    from ..core.config import MatchConfig
    from . import checkpoint as ckpt_mod
    from . import metrics as metrics_mod
    from . import slam as slam_mod

    s = SiftTPU(argv=flags_argv)
    cfg = s.config_for(H, W)
    scfg = slam_mod.SlamConfig(kf_window=a.kf_window,
                               loop_closure=not a.no_loop)
    intr = (a.focal, a.focal, W / 2.0, H / 2.0)
    ml = metrics_mod.MetricsLogger(a.metrics) if a.metrics else None
    resume = (
        ckpt_mod.load_slam_state(a.checkpoint)
        if a.resume and a.checkpoint else None
    )
    t0 = time.perf_counter()
    res = slam_mod.run_slam(
        frames, intr, cfg, MatchConfig(max_match=cfg.max_keypoints), scfg,
        metrics=ml, checkpoint_path=a.checkpoint, resume=resume,
    )
    # final Sim(3) pose-graph pass over ALL keyframes before export (loop
    # corrections already applied online by default; this consumes any edge
    # accepted after the last correction) — the exported TUM trajectory is
    # loop-corrected, matching the config-5 pipeline (ADVICE r3 #1)
    if res.loop_edges:
        applied = slam_mod.apply_pose_graph_sim3(
            res.keyframes, res.trajectory, res.map_points, res.map_mask,
            res.map_anchor, res.loop_edges, odo_edges=res.odo_edges,
        )
        if applied:
            # points-only consistency refit against the corrected poses
            # (anchor transport is slightly non-rigid across anchors)
            slam_mod.refit_map_points(
                res.keyframes, res.map_points, res.map_mask, intr
            )
    dt = time.perf_counter() - t0
    print(
        f"{T} frames in {dt:.1f}s ({T / dt:.1f} fps incl. compile): "
        f"{len(res.keyframe_indices)} keyframes, "
        f"{int(res.map_mask.sum())} map points, "
        f"{len(res.loop_edges or [])} loop closures"
    )
    if a.traj:
        from . import siftio

        siftio.save_trajectory_tum(a.traj, res.trajectory)
        print(f"wrote {a.traj} (TUM format)")
    return 0


_COMMANDS = {
    "extract": cmd_extract,
    "match": cmd_match,
    "speed": cmd_speed,
    "twoview": cmd_twoview,
    "slam": cmd_slam,
    "dump": cmd_dump,
    "serve": cmd_serve,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--cpu" in argv:
        # --cpu runs on the CPU backend even where a GPU is present (set
        # before any computation; same as JAX_PLATFORMS=cpu)
        argv.remove("--cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in _COMMANDS:
        print(__doc__)
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    return _COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
