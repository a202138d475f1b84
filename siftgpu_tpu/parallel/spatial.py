"""Spatially-sharded extraction: halo-exchanged row slabs over the mesh.

The sequence/context-parallelism analog (SURVEY.md §2.3 SP/CP row, §5.7 ⚠):
the reference handles big frames by DOWNSAMPLING to `_texMaxDim`; here
1080p/4K frames are sharded by rows across the `spatial` mesh axis and
processed exactly:

  per octave:
    1. each shard re-exchanges a fixed `halo` of boundary rows with its ring
       neighbors via `lax.ppermute` (device-to-device traffic only);
    2. global image-boundary shards emulate replicate padding by re-clamping
       their outer halo after EVERY blur (this makes edge-shard halos exact,
       not approximate);
    3. the shared per-octave pipeline (detect/orient/describe) runs on the
       padded slab; candidates are restricted to owned rows, coordinates
       shifted to global, and the true image border re-applied globally;
    4. the next octave's base is the decimated owned region.

  Octaves whose per-shard rows drop below `min_rows` switch to GATHERED mode:
  the (tiny) coarse base is `all_gather`ed and processed replicated, with
  only shard 0 owning the results — SURVEY §7.4 item 5's "coarse octaves are
  cheaper gathered".

Exactness: halo (default 96 rows/octave) >= accumulated blur radius (~40) +
max descriptor window reach (~56), so owned-keypoint results are bit-identical
to the single-chip path (tests/test_parallel.py asserts this).
"""

from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ..core.config import SiftConfig
from ..frontend import extract as fe
from ..frontend import pyramid
from ..frontend.extract import Features
from ..frontend.pyramid import Octave

__all__ = ["extract_features_spatial"]


def _exchange_halo(x: jax.Array, h: int, axis: str, idx, n: int) -> jax.Array:
    """x: [B, r, W] -> [B, r + 2h, W]; ring halo exchange with edge
    replication at the global image boundary.

    Supports h > r via multi-hop ring passes (each hop forwards a full slab;
    hop k delivers slab idx-/+k).  Halo rows whose global row index falls
    outside [0, n*r) are replaced by the replicated global edge row."""
    B, r, W = x.shape
    hops = min((h + r - 1) // r, n - 1)
    down = x  # after k hops: device i holds slab of device i-k
    up = x    # after k hops: device i holds slab of device i+k
    above_parts, below_parts = [], []
    for _ in range(hops):
        down = jax.lax.ppermute(down, axis, [(i, i + 1) for i in range(n - 1)])
        up = jax.lax.ppermute(up, axis, [(i + 1, i) for i in range(n - 1)])
        above_parts.insert(0, down)       # ordered top -> bottom
        below_parts.append(up)
    if hops:
        above_full = jnp.concatenate(above_parts, axis=1)[:, -h:]
        below_full = jnp.concatenate(below_parts, axis=1)[:, :h]
        if hops * r < h:
            # hops were clipped at n-1: every unfetched row is outside the
            # image (|g| beyond the ring) and gets the replicate fill below
            pad = h - hops * r
            above_full = jnp.pad(above_full, ((0, 0), (pad, 0), (0, 0)))
            below_full = jnp.pad(below_full, ((0, 0), (0, pad), (0, 0)))
    else:
        above_full = jnp.zeros((B, h, W), x.dtype)
        below_full = jnp.zeros((B, h, W), x.dtype)

    ar = jnp.arange(h, dtype=jnp.int32)
    # replace out-of-image halo rows with the global edge row (replicate pad)
    g_above = idx * r - h + ar                       # global row per halo row
    pos0 = jnp.clip(h - idx * r, 0, h - 1)
    row0_above = jax.lax.dynamic_slice_in_dim(above_full, pos0, 1, axis=1)
    row0 = jnp.where(idx == 0, x[:, :1], row0_above)
    above = jnp.where((g_above < 0)[None, :, None], row0, above_full)

    g_below = (idx + 1) * r + ar
    pos1 = jnp.clip((n - 1 - idx) * r - 1, 0, h - 1)
    rowN_below = jax.lax.dynamic_slice_in_dim(below_full, pos1, 1, axis=1)
    rowN = jnp.where(idx == n - 1, x[:, -1:], rowN_below)
    below = jnp.where((g_below >= n * r)[None, :, None], rowN, below_full)

    return jnp.concatenate([above, x, below], axis=1)


def _reclamp(padded: jax.Array, h: int, idx, n: int) -> jax.Array:
    """Re-impose replicate padding on the outer halo of global-boundary shards
    (after every blur): emulates the single-chip conv's edge padding exactly."""
    top = jnp.repeat(padded[:, h : h + 1], h, axis=1)
    bot = jnp.repeat(padded[:, -h - 1 : -h], h, axis=1)
    p = jnp.where(idx == 0, jnp.concatenate([top, padded[:, h:]], axis=1), padded)
    p = jnp.where(
        idx == n - 1, jnp.concatenate([p[:, :-h], bot], axis=1), p
    )
    return p


def _octave_levels(
    base: jax.Array, cfg: SiftConfig, first: bool, h: int, idx, n: int
) -> Octave:
    """Gaussian/DoG levels from a halo-padded slab with boundary re-clamping."""
    levels = []
    x = base
    if first:
        x = pyramid.blur_separable(
            x, cfg.gaussian_taps(cfg.initial_blur_sigma())
        )
        x = _reclamp(x, h, idx, n)
    levels.append(x)
    for s in cfg.incremental_sigmas():
        x = pyramid.blur_separable(
            x, cfg.gaussian_taps(float(s))
        )
        x = _reclamp(x, h, idx, n)
        levels.append(x)
    gauss = jnp.stack(levels, axis=1)
    return Octave(gauss=gauss, dog=gauss[:, 1:] - gauss[:, :-1])


def extract_features_spatial(
    images: jax.Array, cfg: SiftConfig, mesh: Mesh, axis: str = "spatial",
    halo: int = 96, min_rows: int = 32,
) -> Features:
    """images: [B, H, W]; H must be divisible by n * 2^(spatial octaves).
    Returns replicated Features identical to `extract_features(images, cfg)`."""
    assert cfg.first_octave >= 0, "spatial mode does not support -fo -1 yet"
    for _ in range(cfg.first_octave):  # -fo n > 0: pre-decimate before sharding
        images = pyramid.downsample2x(images)
    n = mesh.shape[axis]
    B, H, W = images.shape
    assert H % n == 0, f"rows {H} not divisible by {n} shards"

    # statically plan which octaves run sharded vs gathered
    rows = H // n
    plan: List[str] = []
    for o in range(cfg.octaves):
        if rows >= max(min_rows, 2) and rows % 2 == 0:
            plan.append("spatial")
            rows //= 2
        else:
            plan.append("gathered")

    def shard_fn(slab: jax.Array) -> Features:
        idx = jax.lax.axis_index(axis)
        base = slab                      # [B, r_o, W_o] owned rows at octave o
        parts = []
        gathered_base = None
        for o in range(cfg.octaves):
            H_o, W_o = cfg.octave_shape(o)
            if plan[o] == "gathered":
                gathered_base = jax.lax.all_gather(base, axis, axis=1, tiled=True)
                break
            r_o = base.shape[1]
            padded = _exchange_halo(base, halo, axis, idx, n)
            padded = _reclamp(padded, halo, idx, n)
            octv = _octave_levels(padded, cfg, first=(o == 0), h=halo, idx=idx, n=n)
            y0 = idx * r_o - halo
            cand = fe.octave_candidates(
                octv, cfg, cfg.octave_cap(o), y0=y0, global_h=H_o,
                owned_rows=(halo, halo + r_o),
            )
            # shift to global octave coords + re-apply the true image border
            gy = cand["y"] + y0.astype(jnp.float32)
            bd = float(cfg.border)
            cand["mask"] &= (gy >= bd) & (gy < H_o - bd)
            cand["y"] = gy
            parts.append(fe.to_image_coords(cand, cfg, o, B))
            base = pyramid.downsample2x(octv.gauss[:, cfg.dog_levels, halo : halo + r_o])

        if gathered_base is not None:
            o0 = plan.index("gathered")
            base_full = gathered_base
            x = base_full
            # remaining octaves: replicated single-chip pipeline
            levels_first = True
            for o in range(o0, cfg.octaves):
                levels = [x]
                if levels_first and o0 == 0:
                    # (only possible when no spatial octave ran at all)
                    levels = [
                        pyramid.blur_separable(
                            x, cfg.gaussian_taps(cfg.initial_blur_sigma())
                        )
                    ]
                for s in cfg.incremental_sigmas():
                    levels.append(
                        pyramid.blur_separable(
                            levels[-1], cfg.gaussian_taps(float(s))
                        )
                    )
                gauss = jnp.stack(levels, axis=1)
                octv = Octave(gauss=gauss, dog=gauss[:, 1:] - gauss[:, :-1])
                cand = fe.octave_candidates(octv, cfg, cfg.octave_cap(o))
                cand["mask"] &= idx == 0       # shard 0 owns replicated octaves
                parts.append(fe.to_image_coords(cand, cfg, o, B))
                x = gauss[:, cfg.dog_levels, ::2, ::2]
                levels_first = False

        # gather candidate buffers from all shards -> identical on every shard
        gparts = []
        for p_ in parts:
            g = {}
            for k, v in p_.items():
                gv = jax.lax.all_gather(v, axis, axis=0)      # [n, B, K, ...]
                g[k] = jnp.moveaxis(gv, 0, 1).reshape(
                    (B, -1) + v.shape[2:]
                )
            gparts.append(g)
        return fe.assemble_features(gparts, cfg)

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=P(None, axis, None),
        out_specs=Features(
            x=P(), y=P(), sigma=P(), theta=P(), response=P(),
            octave=P(), desc=P(), mask=P(),
        ),
        check_vma=False,
    )
    return jax.jit(fn)(images)
