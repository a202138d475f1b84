"""Distributed bundle adjustment: map-block partitioning + psum'd Schur solve.

Replacement for the reference's entire "distributed backend"
(`ServerSiftGPU` TCP RPC, SURVEY.md §2.2/§5.8 ⚠): no RPC layer — SPMD over a
mesh axis.  Points and their observations are partitioned into per-device
blocks (camera-locality partitioning, SURVEY §7.4 item 4); cameras are
replicated.  Each LM/CG step needs exactly one `psum` of the camera-side
partials over the device interconnect; point marginalization (H_pp^-1) stays shard-local.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..optim import ba

__all__ = ["ShardedBAProblem", "partition_problem", "run_ba_distributed"]


class ShardedBAProblem(NamedTuple):
    """Leading axis = shard (length n_shards); cameras/intrinsics replicated."""
    cams: jax.Array        # [M, 6]
    points: jax.Array      # [S, Ps, 3]
    intrinsics: jax.Array  # [4]
    cam_idx: jax.Array     # [S, Ns]
    pt_idx: jax.Array      # [S, Ns]  (LOCAL point indices)
    uv: jax.Array          # [S, Ns, 2]
    w: jax.Array           # [S, Ns]
    pt_fixed: jax.Array    # [S, Ps] bool (see ba.BAProblem.pt_fixed)


def partition_problem(prob: ba.BAProblem, n_shards: int) -> ShardedBAProblem:
    """Host-side partitioning: points round-robin by index block, observations
    follow their point.  Shards are padded to equal (static) sizes with
    zero-weight observations."""
    pts = np.asarray(prob.points)
    cam_idx = np.asarray(prob.cam_idx)
    pt_idx = np.asarray(prob.pt_idx)
    uv = np.asarray(prob.uv)
    w = np.asarray(prob.w)
    n_pts = pts.shape[0]

    # contiguous point blocks (points from the same track/keyframe are created
    # adjacently upstream -> locality preserved)
    bounds = np.linspace(0, n_pts, n_shards + 1).astype(int)
    Ps = int(max(np.diff(bounds).max(), 1))
    Ns = 0
    shard_obs = []
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        sel = np.nonzero((pt_idx >= lo) & (pt_idx < hi))[0]
        shard_obs.append((lo, hi, sel))
        Ns = max(Ns, len(sel))
    Ns = max(Ns, 1)

    fixed = (np.asarray(prob.pt_fixed) if prob.pt_fixed is not None
             else np.zeros(n_pts, bool))
    points_s = np.zeros((n_shards, Ps, 3), np.float32)
    fixed_s = np.zeros((n_shards, Ps), bool)
    cam_s = np.zeros((n_shards, Ns), np.int32)
    pt_s = np.zeros((n_shards, Ns), np.int32)
    uv_s = np.zeros((n_shards, Ns, 2), np.float32)
    w_s = np.zeros((n_shards, Ns), np.float32)
    for s, (lo, hi, sel) in enumerate(shard_obs):
        k = len(sel)
        points_s[s, : hi - lo] = pts[lo:hi]
        fixed_s[s, : hi - lo] = fixed[lo:hi]
        cam_s[s, :k] = cam_idx[sel]
        pt_s[s, :k] = pt_idx[sel] - lo
        uv_s[s, :k] = uv[sel]
        w_s[s, :k] = w[sel]

    return ShardedBAProblem(
        cams=jnp.asarray(prob.cams),
        points=jnp.asarray(points_s),
        intrinsics=jnp.asarray(prob.intrinsics),
        cam_idx=jnp.asarray(cam_s),
        pt_idx=jnp.asarray(pt_s),
        uv=jnp.asarray(uv_s),
        w=jnp.asarray(w_s),
        pt_fixed=jnp.asarray(fixed_s),
    )


def run_ba_distributed(
    sprob: ShardedBAProblem, mesh: Mesh, axis: str = "ba",
    iters: int = 10, n_cg: int = 30, fix_first_cam: bool = True,
    lam0: float = 1e-3,
) -> Tuple[ba.BAState, jax.Array]:
    """Returns (state with replicated cams + this function's sharded points
    re-stacked to [S, Ps, 3], per-iteration psum'd cost)."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(axis), P(), P(axis), P(axis), P(axis), P(axis), P(axis),
        ),
        out_specs=(P(), P(axis), P(), P()),
        check_vma=False,
    )
    def shard_fn(cams, points, intr, cam_idx, pt_idx, uv, w, pt_fixed):
        local = ba.BAProblem(
            cams=cams, points=points[0], intrinsics=intr,
            cam_idx=cam_idx[0], pt_idx=pt_idx[0], uv=uv[0], w=w[0],
            pt_fixed=pt_fixed[0],
        )
        st = ba.run_ba_impl(
            local, iters=iters, n_cg=n_cg, fix_first_cam=fix_first_cam,
            lam0=lam0, psum_axis=axis,
        )
        return st.cams, st.points[None], st.lam, st.cost

    from . import multihost

    args = multihost.globalize_args(
        (sprob.cams, sprob.points, sprob.intrinsics,
         sprob.cam_idx, sprob.pt_idx, sprob.uv, sprob.w, sprob.pt_fixed),
        (P(), P(axis), P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
        mesh,
    )
    cams, points, lam, cost = jax.jit(shard_fn)(*args)
    return ba.BAState(cams=cams, points=points, lam=lam, cost=cost), cost
