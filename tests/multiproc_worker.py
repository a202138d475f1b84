"""Worker process for the TRUE multi-process `jax.distributed` test.

SURVEY.md §4.3: the reference's distribution layer (`ServerSiftGPU` TCP RPC ⚠)
was never tested across processes; here two OS processes form one 8-device
global CPU mesh (4 virtual devices each) and run the distributed
Schur-complement BA — every collective crosses a real process boundary, the
same code path a multi-host mesh takes over the network.

Invoked by tests/test_multiprocess.py:
    python multiproc_worker.py <pid> <nproc> <coordinator_port> <out.json>
"""

import json
import os
import sys


def main() -> None:
    pid, nproc, port, out_path = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    )
    import jax

    # CPU-only child: the processes share the host's virtual devices
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 4 * nproc, jax.device_count()

    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_ba import _make_problem

    from siftgpu_tpu.optim import ba
    from siftgpu_tpu.parallel import dist_ba

    n_shards = jax.device_count()
    prob, _, _ = _make_problem(n_cams=4, n_pts=64, seed=7)
    sprob = dist_ba.partition_problem(prob, n_shards)
    mesh = Mesh(np.asarray(jax.devices()), axis_names=("ba",))

    def globalize(x, spec):
        """Every process holds the full array -> global sharded jax.Array."""
        host = np.asarray(x)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(host.shape, sh, lambda i: host[i])

    gprob = dist_ba.ShardedBAProblem(
        cams=globalize(sprob.cams, P()),
        points=globalize(sprob.points, P("ba")),
        intrinsics=globalize(sprob.intrinsics, P()),
        cam_idx=globalize(sprob.cam_idx, P("ba")),
        pt_idx=globalize(sprob.pt_idx, P("ba")),
        uv=globalize(sprob.uv, P("ba")),
        w=globalize(sprob.w, P("ba")),
        pt_fixed=globalize(sprob.pt_fixed, P("ba")),
    )
    state, _ = dist_ba.run_ba_distributed(
        gprob, mesh, axis="ba", iters=8, n_cg=25
    )
    # replicated outputs are addressable on every process
    cost = float(np.asarray(jax.device_get(state.cost)))
    cams = np.asarray(jax.device_get(state.cams))

    # single-device reference on this process's local device 0
    ref = ba.run_ba(prob, iters=8, n_cg=25)
    rot_err = float(
        np.abs(cams[:, :3] - np.asarray(ref.cams[:, :3])).max()
    )

    if pid == 0:
        with open(out_path, "w") as f:
            json.dump(
                {
                    "cost": cost,
                    "ref_cost": float(ref.cost),
                    "rot_err": rot_err,
                    "devices": jax.device_count(),
                    "processes": jax.process_count(),
                },
                f,
            )
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
