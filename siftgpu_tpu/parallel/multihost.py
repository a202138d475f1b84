"""Multi-process (multi-controller) array plumbing for the config-5 pipeline.

The reference's distribution layer was a TCP RPC server (`ServerSiftGPU`,
SURVEY.md §2.2/§5.8 ⚠) that shipped descriptors between processes by hand.
This pipeline is SPMD instead: every process runs the identical
Python program over one GLOBAL mesh (`jax.distributed.initialize`), and the
only cross-process traffic is the collectives XLA inserts.  That leaves one
mechanical obligation, handled here: host-side numpy state (which every
process computes identically — the tracking loop is deterministic) must be
lifted into global `jax.Array`s before it can enter a `jit`/`shard_map` over
a mesh that spans non-addressable devices, and sharded outputs must be
re-replicated before the host may read them back.

Single-process behavior is untouched: every helper is the identity (or a
plain `np.asarray`) when `jax.process_count() == 1`, so the virtual-mesh
tests exercise the exact same code path minus the lifting.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

__all__ = ["multiprocess", "globalize", "globalize_args", "host_read"]


def multiprocess() -> bool:
    """True when this run spans >1 OS process (multi-controller JAX)."""
    try:
        return jax.process_count() > 1
    except Exception:
        return False


def globalize(x, mesh: Mesh, spec: P):
    """Lift a process-identical host array to a global sharded jax.Array.

    Every process must hold the SAME full value (true for all config-5
    host state: the partitioners are deterministic numpy).  Each process
    donates only the shards its local devices own."""
    host = np.asarray(x)
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(host.shape, sh, lambda idx: host[idx])


def globalize_args(args, specs, mesh: Mesh):
    """Lift a tuple of arrays to global arrays matching `specs` (the
    shard_map in_specs).  No-op outside multi-process runs; arguments that
    are ALREADY multi-device global arrays (e.g. a caller lifted them
    itself, as tests/multiproc_worker.py does) pass through untouched —
    re-lifting would read non-addressable shards and fail."""
    if not multiprocess():
        return args
    return tuple(
        a
        if isinstance(a, jax.Array) and len(a.sharding.device_set) > 1
        else globalize(a, mesh, s)
        for a, s in zip(args, specs)
    )


def host_read(x, mesh: Mesh = None):
    """Global array -> host numpy on EVERY process.

    Replicated (or single-process) arrays read directly; sharded ones are
    re-replicated first via a jitted identity with replicated out-sharding
    (an XLA all-gather across the mesh)."""
    if not multiprocess():
        return np.asarray(x)
    if getattr(x, "is_fully_replicated", False) or getattr(
        x, "is_fully_addressable", False
    ):
        return np.asarray(jax.device_get(x))
    m = mesh if mesh is not None else x.sharding.mesh
    rep = jax.jit(
        lambda a: a, out_shardings=NamedSharding(m, P())
    )(x)
    return np.asarray(jax.device_get(rep))
