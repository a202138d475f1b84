"""Data-parallel extraction/matching over the `data` mesh axis.

The `MultiThreadSIFT` thread-per-GPU / image-list analog (SURVEY.md §2.3 DP
row ⚠) — here it is just a sharding annotation: the whole front end is batched
with the frame axis outermost, so `jit` + NamedSharding partitions frames
across devices and XLA inserts nothing but the final gather (if any).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..core.config import SiftConfig
from ..frontend.extract import Features, extract_features

__all__ = ["extract_features_dp"]


def extract_features_dp(
    images: jax.Array, cfg: SiftConfig, mesh: Mesh, axis: str = "data"
) -> Features:
    """images: [B, H, W] with B divisible by the `axis` size.  Returns
    Features sharded along the batch axis (kept device-resident).

    Uses `shard_map` rather than jit+sharding annotations: extraction is
    purely batch-parallel, but the SPMD partitioner all-gathers every
    `lax.top_k` operand over the batch axis (TopK/Sort partitioning
    limitation, seen in the optimized HLO),
    duplicating the sort on every device.  shard_map runs the whole program
    on the local batch: ZERO collectives, exact same outputs."""
    from . import multihost

    if multihost.multiprocess():
        # device_put cannot target non-addressable devices; lift the
        # process-identical batch to a global sharded array instead
        images = multihost.globalize(images, mesh, P(axis))
    else:
        images = jax.device_put(images, NamedSharding(mesh, P(axis)))
    return _dp_fn(cfg, mesh, axis)(images)


@lru_cache(maxsize=32)
def _dp_fn(cfg: SiftConfig, mesh: Mesh, axis: str):
    """Cached jit wrapper: a fresh jax.jit per call would re-trace every
    chunk of a sequence (the tracing cache lives on the wrapper object)."""
    return jax.jit(
        jax.shard_map(
            partial(extract_features, cfg=cfg),
            mesh=mesh,
            in_specs=P(axis),
            out_specs=P(axis),
            check_vma=False,
        )
    )
