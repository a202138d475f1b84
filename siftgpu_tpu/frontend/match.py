"""Descriptor matching: brute-force best-2 + ratio test, and guided variants.

Replacement for `SiftMatchGPU` / `ProgramCU::MultiplyDescriptor[G]` +
`GetRowMatch/GetColMatch` (SURVEY.md §2.4 items 7-8, §3.2 ⚠).  The n0 x n1 x 128
dot-product volume is one matrix product.  uint8 descriptors (the production
format, and the reference's own `MultiplyDescriptor` design point: tiled uint8
dot-products) take the exact-bf16 path (`_u8_parts`/`_u8_sim`): uint8 values
(0..255) are exact in bf16's 8 significand bits and the 128-term integer dot
stays < 2^23, so ONE bf16 pass with f32 accumulation reproduces the integer dot
bit-exactly — no recentering or multi-pass emulation — followed by a single
f32 reciprocal-norm epilogue.  (An int8-recenter + rank-1-correction scheme
was the first design; the bf16-exact form replaced it — same exactness, one
pass, no correction term.)  Float descriptors fall back to L2-normalized f32
at HIGHEST precision.  Distances are angular — d = arccos(sim) — matching the
reference's acos + distmax(0.7)/ratiomax(0.8)/mutual-best semantics.

The reference reads best/second rows back to the host and finishes on CPU;
here selection stays in-graph on fixed-capacity buffers:
`matches [max_match, 2]` padded with -1 plus an in-graph count.

For capacities up to SetMaxSift's ~8k the full similarity matrix is small
(64 MB f32 at 4k x 4k) and XLA pipelines it; `MatchConfig.block_size > 0`
switches to the blockwise streaming path (`_match_streaming`):
FlashAttention-style running best-2 under `lax.scan`, identical selection
semantics, O(N0 * block) memory — for sets far beyond 8k.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.config import MatchConfig

__all__ = [
    "MatchResult", "match_descriptors", "match_descriptors_batch",
    "guided_match_descriptors",
]

_HI = jax.lax.Precision.HIGHEST


class MatchResult(NamedTuple):
    pairs: jax.Array   # [max_match, 2] int32, -1-padded
    count: jax.Array   # [] int32
    dist: jax.Array    # [max_match] angular distance of each pair (padded 0)


def _normalize(d: jax.Array) -> jax.Array:
    f = d.astype(jnp.float32)
    n = jnp.linalg.norm(f, axis=-1, keepdims=True)
    return f / jnp.maximum(n, 1e-12)


_INT_DOT = (((1,), (1,)), ((), ()))


def _is_u8(*ds) -> bool:
    return all(d.dtype == jnp.uint8 for d in ds)


def _u8_parts(d: jax.Array):
    """bf16 view + per-row reciprocal L2 norm for exact uint8 dots.

    uint8 values (0..255) are exact in bf16 (8 significand bits) and the
    128-term integer dot stays < 2^23, so ONE bf16 pass with f32
    accumulation reproduces the uint8 dot bit-exactly (checked against an
    int64 NumPy brute force by chip_smoke.py) — no recentering or
    multi-pass emulation needed."""
    i = d.astype(jnp.int32)
    sq = (i * i).sum(axis=1, dtype=jnp.int32).astype(jnp.float32)
    rn = jax.lax.rsqrt(jnp.maximum(sq, 1e-24))
    return d.astype(jnp.bfloat16), rn


def _u8_sim(parts0, parts1) -> jax.Array:
    """Cosine similarity block from `_u8_parts` tuples (bf16 dot, f32
    accumulation); the dense and streaming paths share this rounding order
    `(dot * rn1) * rn0`, so their selections agree bit for bit."""
    b0, rn0 = parts0
    b1, rn1 = parts1
    dot = jax.lax.dot_general(
        b0, b1, _INT_DOT, preferred_element_type=jnp.float32
    )
    return (dot * rn1[None, :]) * rn0[:, None]


def _best2_sim(sim: jax.Array):
    """Per-row best & second-best SIMILARITY. sim: [N, M] (higher = closer).

    The winner is knocked out with a compare+select against a column iota,
    one fused pass with no scatter."""
    best_j = jnp.argmax(sim, axis=1)
    best = jnp.max(sim, axis=1)
    cols = jax.lax.broadcasted_iota(jnp.int32, sim.shape, 1)
    masked = jnp.where(cols == best_j[:, None].astype(jnp.int32), -jnp.inf, sim)
    second = jnp.max(masked, axis=1)
    return best, second, best_j


def _finalize(bsim, ssim, best_j, col_best_i, cfg: MatchConfig) -> MatchResult:
    """Threshold + mutual-best + fixed-capacity compaction from per-row
    best-2 similarities (shared by the dense and streaming paths).

    arccos is monotonically decreasing, so best-2/mutual selection runs on
    raw dot products (no [N, M] transcendental pass — it cost more than the
    matmul); angles are computed only for the per-row winners to apply the
    reference's angular distmax/ratiomax thresholds.
    """
    n0 = bsim.shape[0]
    best = jnp.arccos(jnp.clip(bsim, -1.0, 1.0))
    second = jnp.arccos(jnp.clip(ssim, -1.0, 1.0))
    second = jnp.where(jnp.isfinite(ssim), second, jnp.inf)
    ok = (best < cfg.dist_max) & (best < cfg.ratio_max * second)
    if cfg.mutual_best:
        ok &= col_best_i[best_j] == jnp.arange(n0)
    ok &= jnp.isfinite(bsim)

    # compact valid rows into the fixed buffer, preserving row order, on
    # (valid-first, row-order) keys — no scatter.  With max_match < N0
    # lax.top_k on the negated key selects the first max_match valid rows
    # directly (top_k(k << n) is the cheaper shape than a full argsort).
    # At capacity == N0 a full-width reorder is sort-class work anyway, so
    # argsort stays.
    rows = jnp.arange(n0, dtype=jnp.int32)
    key = jnp.where(ok, rows, n0 + rows)            # valid first, row order
    m = cfg.max_match
    if m < n0:
        # largest m of -key == smallest m keys, descending -key order ==
        # ascending key order (exactly argsort(key)[:m]); invalid rows
        # carry key = n0 + row — strip the offset so the (masked-out)
        # tail slots still gather in range
        negv, _ = jax.lax.top_k(-key, m)
        perm_m = jnp.where(-negv < n0, -negv, -negv - n0)
    else:
        perm = jnp.argsort(key)
        perm_m = perm[:m] if n0 >= m else jnp.pad(perm, (0, m - n0))
    count = jnp.minimum(ok.sum(), m).astype(jnp.int32)
    valid_slot = jnp.arange(m) < count
    pr = jnp.stack(
        [perm_m.astype(jnp.int32), best_j[perm_m].astype(jnp.int32)], axis=1
    )
    return MatchResult(
        pairs=jnp.where(valid_slot[:, None], pr, -1),
        count=count,
        dist=jnp.where(valid_slot, best[perm_m], 0.0),
    )


def _select(sim, mask0, mask1, cfg: MatchConfig) -> MatchResult:
    """Fixed-capacity selection from a full SIMILARITY matrix."""
    sim = jnp.where(mask0[:, None] & mask1[None, :], sim, -jnp.inf)
    bsim, ssim, best_j = _best2_sim(sim)
    col_best_i = jnp.argmax(sim, axis=0) if cfg.mutual_best else None
    return _finalize(bsim, ssim, best_j, col_best_i, cfg)


def _match_streaming(
    d0, d1, mask0, mask1, cfg: MatchConfig,
    loc0=None, loc1=None, H=None, F=None,
    hdist_max: float = 32.0, fdist_max: float = 16.0,
) -> MatchResult:
    """Blockwise streaming matcher: `_stream_best2` then `_finalize`."""
    return _finalize(
        *_stream_best2(d0, d1, mask0, mask1, cfg, loc0, loc1, H, F,
                       hdist_max, fdist_max),
        cfg,
    )


def _stream_best2(
    d0, d1, mask0, mask1, cfg: MatchConfig,
    loc0=None, loc1=None, H=None, F=None,
    hdist_max: float = 32.0, fdist_max: float = 16.0,
):
    """Blockwise streaming best-2 (the FlashAttention-style path,
    SURVEY.md §2.4 item 7): d1 is processed in `cfg.block_size`-column
    blocks under `lax.scan`, carrying per-row running (best, second, argbest)
    — the [N0, N1] similarity matrix is never materialized, so descriptor
    sets far beyond SetMaxSift's ~8k (64 MB at 4k x 4k f32) fit in device
    memory.  Column-side best rows (mutual check) complete within each
    block, which holds all N0 rows.  Bit-identical selection semantics to the
    dense path (first-index tie-breaks preserved by the strict `>` merge).

    With `H`/`F` set this is the STREAMING GUIDED matcher: the reprojection /
    epipolar gates are computed per loc1 block inside the scan, so the
    [N0, N1] gate matrices are never materialized either.

    Returns per-row (best, second) similarities [N0], the best column [N0],
    and each column's best row [N1] (None without `cfg.mutual_best`)."""
    Bc = cfg.block_size
    n0, n1 = d0.shape[0], d1.shape[0]
    pad = (-n1) % Bc
    if _is_u8(d0, d1):
        # integer path: per-block exact bf16 dots + rn epilogue.
        parts0 = _u8_parts(d0)
        b1, rn1 = _u8_parts(d1)
        if pad:  # zero-pads give finite sims; mask1 padding kills them below
            b1 = jnp.pad(b1, ((0, pad), (0, 0)))
            rn1 = jnp.pad(rn1, (0, pad))
        nb = b1.shape[0] // Bc
        d1b = (b1.reshape(nb, Bc, -1), rn1.reshape(nb, Bc))
        simfn = lambda blk: _u8_sim(parts0, blk)
    else:
        f0 = _normalize(d0)
        f1 = _normalize(d1)
        if pad:
            f1 = jnp.pad(f1, ((0, pad), (0, 0)))
        nb = f1.shape[0] // Bc
        d1b = (f1.reshape(nb, Bc, -1),)
        simfn = lambda blk: jnp.dot(f0, blk[0].T, precision=_HI)
    if pad:
        mask1 = jnp.pad(mask1, (0, pad))
    m1b = mask1.reshape(nb, Bc)
    guided = H is not None or F is not None
    if guided:
        l1p = jnp.pad(loc1.astype(jnp.float32), ((0, pad), (0, 0)))
        l1b = l1p.reshape(nb, Bc, 2)
    else:
        l1b = jnp.zeros((nb, Bc, 2), jnp.float32)

    def step(carry, blk):
        best, second, best_j = carry
        db, mb, lb, off = blk
        sim = simfn(db)
        keep = mask0[:, None] & mb[None, :]
        if H is not None:
            keep &= _homography_gate(loc0, lb, H, hdist_max)
        if F is not None:
            keep &= _epipolar_gate(loc0, lb, F, fdist_max)
        sim = jnp.where(keep, sim, -jnp.inf)
        b, s, j = _best2_sim(sim)
        # disjoint-candidate top-2 merge; strict > keeps the earlier
        # (lower-index) winner on ties, matching dense argmax
        new_best = jnp.maximum(best, b)
        new_second = jnp.maximum(jnp.maximum(second, s), jnp.minimum(best, b))
        new_j = jnp.where(b > best, j + off, best_j)
        col_i = jnp.argmax(sim, axis=0).astype(jnp.int32)
        return (new_best, new_second, new_j), col_i

    init = (
        jnp.full((n0,), -jnp.inf, jnp.float32),
        jnp.full((n0,), -jnp.inf, jnp.float32),
        jnp.zeros((n0,), jnp.int32),
    )
    offs = jnp.arange(nb, dtype=jnp.int32) * Bc
    (bsim, ssim, best_j), cols = jax.lax.scan(step, init, (d1b, m1b, l1b, offs))
    col_best_i = cols.reshape(nb * Bc)[:n1] if cfg.mutual_best else None
    return bsim, ssim, best_j, col_best_i


def _similarities(d0, d1):
    if _is_u8(d0, d1):
        return _u8_sim(_u8_parts(d0), _u8_parts(d1))
    return jnp.dot(_normalize(d0), _normalize(d1).T, precision=_HI)


def _effective_block(cfg: MatchConfig, n1: int) -> int:
    """Streaming-engagement policy (static — shapes are compile-time).

    block_size > 0: stream with that block when N1 exceeds it (explicit).
    block_size == 0: AUTO — stream with `cfg.stream_block` columns when
      N1 > `cfg.stream_threshold` (beyond SetMaxSift-class capacities the
      dense [N0, N1] f32 similarity buffer and its argmax passes dominate);
      dense below.
    block_size < 0: always dense.
    Returns the block size to use, or 0 for the dense path."""
    if cfg.block_size > 0:
        return cfg.block_size if n1 > cfg.block_size else 0
    if cfg.block_size == 0 and n1 > cfg.stream_threshold:
        return min(cfg.stream_block, n1)
    return 0


def match_descriptors_impl(
    d0: jax.Array, d1: jax.Array,
    mask0: Optional[jax.Array] = None, mask1: Optional[jax.Array] = None,
    cfg: MatchConfig = MatchConfig(),
) -> MatchResult:
    """Unjitted implementation (composable inside larger jitted programs)."""
    if mask0 is None:
        mask0 = jnp.ones(d0.shape[0], bool)
    if mask1 is None:
        mask1 = jnp.ones(d1.shape[0], bool)
    bs = _effective_block(cfg, d1.shape[0])
    if bs:
        return _match_streaming(d0, d1, mask0, mask1, cfg.replace(block_size=bs))
    return _select(_similarities(d0, d1), mask0, mask1, cfg)


@partial(jax.jit, static_argnums=4)
def match_descriptors(
    d0: jax.Array, d1: jax.Array,
    mask0: Optional[jax.Array] = None, mask1: Optional[jax.Array] = None,
    cfg: MatchConfig = MatchConfig(),
) -> MatchResult:
    """d0: [N0, 128], d1: [N1, 128] (uint8 or float). GetSiftMatch analog."""
    return match_descriptors_impl(d0, d1, mask0, mask1, cfg)


@partial(jax.jit, static_argnums=4)
def match_descriptors_batch(
    d0: jax.Array, d1: jax.Array,
    mask0: Optional[jax.Array] = None, mask1: Optional[jax.Array] = None,
    cfg: MatchConfig = MatchConfig(),
) -> MatchResult:
    """Batched pairwise matching: d0, d1 [P, N, 128] -> MatchResult with a
    leading pair axis.  One dispatch for P pairs — the consecutive-frame case
    of the SLAM loop and benchmark."""
    if mask0 is None:
        mask0 = jnp.ones(d0.shape[:2], bool)
    if mask1 is None:
        mask1 = jnp.ones(d1.shape[:2], bool)
    return jax.vmap(
        lambda a, b, m, n: match_descriptors_impl(a, b, m, n, cfg)
    )(d0, d1, mask0, mask1)


def _h_parts(loc0, H):
    """Per-row homography operands: loc0 projected through H -> (px, py).

    The O(N0 x N1) gate then decomposes into rank-1 broadcasts.  The
    3-term products run at HIGHEST: pixel coordinates in TF32 would move
    a projection by ~0.1 px at 1080p."""
    loc0 = loc0.astype(jnp.float32)
    ones = jnp.ones((loc0.shape[0], 1), jnp.float32)
    p = jnp.dot(jnp.concatenate([loc0, ones], axis=1), H.T, precision=_HI)
    z = p[:, 2:]
    p = p[:, :2] / jnp.maximum(jnp.abs(z), 1e-12) * jnp.sign(z)
    return p[:, 0], p[:, 1]


def _f_parts_rows(loc0, F):
    """Per-row epipolar operands: loc0's NORMALIZED epiline in image 1
    (la = F x0 / |la_xy|) plus raw loc0 — row side of the symmetric gate."""
    loc0 = loc0.astype(jnp.float32)
    ones = jnp.ones((loc0.shape[0], 1), jnp.float32)
    l1 = jnp.dot(jnp.concatenate([loc0, ones], axis=1), F.T,
                 precision=_HI)                            # [N0, 3]
    den = jnp.sqrt(l1[:, 0] ** 2 + l1[:, 1] ** 2)
    la = l1 / jnp.maximum(den, 1e-12)[:, None]
    return la[:, 0], la[:, 1], la[:, 2], loc0[:, 0], loc0[:, 1]


def _f_parts_cols(loc1, F):
    """Per-column epipolar operands: loc1's normalized epiline in image 0."""
    loc1 = loc1.astype(jnp.float32)
    ones = jnp.ones((loc1.shape[0], 1), jnp.float32)
    l0 = jnp.dot(jnp.concatenate([loc1, ones], axis=1), F,
                 precision=_HI)                            # [N1, 3]
    den = jnp.sqrt(l0[:, 0] ** 2 + l0[:, 1] ** 2)
    lb = l0 / jnp.maximum(den, 1e-12)[:, None]
    return lb[:, 0], lb[:, 1], lb[:, 2]


def _homography_gate(loc0, loc1, H, hdist_max):
    """Squared reprojection gate |H x0 - x1|^2 < hdist_max^2. -> [N0, N1] bool.

    Built from `_h_parts` (the dense and streaming paths share it)."""
    px, py = _h_parts(loc0, H)
    loc1 = loc1.astype(jnp.float32)
    dx = px[:, None] - loc1[None, :, 0]
    dy = py[:, None] - loc1[None, :, 1]
    return dx * dx + dy * dy < hdist_max * hdist_max


def _epipolar_gate(loc0, loc1, F, fdist_max):
    """Symmetric epipolar-distance gate via F. -> [N0, N1] bool.

    max(|la . x1|, |x0 . lb|) with PRE-normalized lines (`_f_parts_*`) —
    algebraically the classic num/den form, restructured so every pairwise
    term is a rank-1 broadcast."""
    la_x, la_y, la_z, x0x, x0y = _f_parts_rows(loc0, F)
    lb_x, lb_y, lb_z = _f_parts_cols(loc1, F)
    loc1 = loc1.astype(jnp.float32)
    x1, y1 = loc1[:, 0], loc1[:, 1]
    d_a = jnp.abs(la_x[:, None] * x1[None, :]
                  + la_y[:, None] * y1[None, :] + la_z[:, None])
    d_b = jnp.abs(x0x[:, None] * lb_x[None, :]
                  + x0y[:, None] * lb_y[None, :] + lb_z[None, :])
    return jnp.maximum(d_a, d_b) < fdist_max


@partial(jax.jit, static_argnums=(8, 9, 10))
def guided_match_descriptors(
    d0, d1, loc0, loc1,
    H=None, F=None,
    mask0: Optional[jax.Array] = None, mask1: Optional[jax.Array] = None,
    hdist_max: float = 32.0, fdist_max: float = 16.0,
    cfg: MatchConfig = MatchConfig(),
) -> MatchResult:
    """GetGuidedSiftMatch analog: gate pairs by H reprojection / F epipolar
    distance, fused into the score matrix before best-2 selection.  Above
    `cfg.block_size` columns the gates stream per block (no [N0, N1] gate
    matrices), same selection semantics as the dense form."""
    if mask0 is None:
        mask0 = jnp.ones(d0.shape[0], bool)
    if mask1 is None:
        mask1 = jnp.ones(d1.shape[0], bool)
    bs = _effective_block(cfg, d1.shape[0])
    if bs:
        Hj = None if H is None else jnp.asarray(H, jnp.float32)
        Fj = None if F is None else jnp.asarray(F, jnp.float32)
        return _match_streaming(
            d0, d1, mask0, mask1, cfg.replace(block_size=bs),
            loc0=jnp.asarray(loc0, jnp.float32), loc1=jnp.asarray(loc1),
            H=Hj, F=Fj, hdist_max=hdist_max, fdist_max=fdist_max,
        )
    sim = _similarities(d0, d1)
    gate = jnp.ones_like(sim, dtype=bool)
    if H is not None:
        gate &= _homography_gate(loc0, loc1, jnp.asarray(H, jnp.float32), hdist_max)
    if F is not None:
        gate &= _epipolar_gate(loc0, loc1, jnp.asarray(F, jnp.float32), fdist_max)
    sim = jnp.where(gate, sim, -jnp.inf)
    return _select(sim, mask0, mask1, cfg)
