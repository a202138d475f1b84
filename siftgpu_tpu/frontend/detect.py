"""Keypoint detection: DoG extrema -> contrast/edge tests -> subpixel refine.

Replacement for `ProgramCU::ComputeKEY` + the histogram-pyramid
list generation (`InitHist/ReduceHist/ListGen`, SURVEY.md §2.4 items 3-4 ⚠).
The reference compacts variable-length keypoint lists on the GPU and reads the
count back to the host; here there are NO host syncs and NO dynamic shapes:

  1. dense extrema / contrast / edge masks AND the dense closed-form
     (Cramer) subpixel solve over the DoG volume in one elementwise pass
     that XLA fuses — the pass already holds all 27 taps, so it emits a
     per-pixel refinement record (val, off_l, off_y, off_x) alongside the
     score planes;
  2. per-octave exact `top_k` of |DoG| over 2x2-pooled candidate scores
     into a fixed-capacity buffer (deterministic: score desc, flat index
     asc — SURVEY §7.4 item 1), winner pixel recovered from the block
     corner index packed in the score's low mantissa bits;
  3. ONE packed `take_along_axis` pulls each survivor's 4-field record,
     merged across ALL octaves by `detect_pyramid`;
  4. offset/contrast/border validity tests on the gathered records.

The candidate ordering uses the *unrefined* |DoG| response; the oracle orders
by refined response.  Identical sets whenever the cap is not binding.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.config import SiftConfig
from .pyramid import Octave

__all__ = [
    "OctaveKeypoints", "OctaveWinners",
    "cramer_record", "detect_octave", "detect_pyramid", "detect_winners",
    "record_indices", "refine_records",
]


class OctaveKeypoints(NamedTuple):
    y: jax.Array          # [B, K] refined row, octave-local float
    x: jax.Array          # [B, K] refined col
    level: jax.Array      # [B, K] refined DoG level (float)
    grad_level: jax.Array # [B, K] int32 in [1, S]: Gaussian level for gradients
    sigma: jax.Array      # [B, K] octave-local scale
    response: jax.Array   # [B, K] |DoG| at the candidate pixel
    mask: jax.Array       # [B, K] bool validity


def _pool3x3(x: jax.Array, op) -> jax.Array:
    """3x3 spatial max/min pool of [B, L, H, W] (edges padded with identity)."""
    init = -jnp.inf if op is jax.lax.max else jnp.inf
    return jax.lax.reduce_window(
        x, init, op, window_dimensions=(1, 1, 3, 3), window_strides=(1, 1, 1, 1),
        padding=((0, 0), (0, 0), (1, 1), (1, 1)),
    )


def _pool8(x: jax.Array, op) -> jax.Array:
    """Max/min over the 8 spatial neighbors, center EXCLUDED."""
    init = -jnp.inf if op is jax.lax.max else jnp.inf
    xp = jnp.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)), constant_values=init)
    H, W = x.shape[-2:]
    shifts = []
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            shifts.append(xp[:, :, dy : dy + H, dx : dx + W])
    out = shifts[0]
    for s in shifts[1:]:
        out = op(out, s)
    return out


def cramer_record(q, subpixel):
    """Dense subpixel-refinement record: the closed-form (Cramer) 3x3 solve
    at every pixel.  `q(dl, dy, dx)` returns the DoG tap array at that
    offset.  Returns (val, off_l, off_y, off_x, (dyy, dxx, dxy)) — the
    spatial Hessian terms are returned so the caller's edge-ratio test
    reuses them instead of recomputing (they are exactly the solve's
    d/f/e_ terms)."""
    vc = q(0, 0, 0)
    # spatial Hessian (needed by the edge test even when subpixel is off)
    d = q(0, 1, 0) + q(0, -1, 0) - 2 * vc
    f = q(0, 0, 1) + q(0, 0, -1) - 2 * vc
    e_ = 0.25 * (q(0, 1, 1) - q(0, 1, -1) - q(0, -1, 1) + q(0, -1, -1))
    if not subpixel:
        zero = vc * 0.0
        return vc, zero, zero, zero, (d, f, e_)
    gl = 0.5 * (q(1, 0, 0) - q(-1, 0, 0))
    gy = 0.5 * (q(0, 1, 0) - q(0, -1, 0))
    gx = 0.5 * (q(0, 0, 1) - q(0, 0, -1))
    a = q(1, 0, 0) + q(-1, 0, 0) - 2 * vc
    b_ = 0.25 * (q(1, 1, 0) - q(1, -1, 0) - q(-1, 1, 0) + q(-1, -1, 0))
    c_ = 0.25 * (q(1, 0, 1) - q(1, 0, -1) - q(-1, 0, 1) + q(-1, 0, -1))
    i00 = d * f - e_ * e_
    i01 = c_ * e_ - b_ * f
    i02 = b_ * e_ - c_ * d
    i11 = a * f - c_ * c_
    i12 = b_ * c_ - a * e_
    i22 = a * d - b_ * b_
    # detH via the first adjugate row (b_*i01 == -b_*(b_*f - c_*e_) exactly:
    # f32 negation is exact, so this is bit-identical to the expanded form
    # while reusing i00/i01/i02)
    detH = a * i00 + b_ * i01 + c_ * i02
    ok_det = jnp.abs(detH) > 1e-12
    inv_det = jnp.where(ok_det, 1.0 / jnp.where(ok_det, detH, 1.0), 0.0)
    off_l = -(i00 * gl + i01 * gy + i02 * gx) * inv_det
    off_y = -(i01 * gl + i11 * gy + i12 * gx) * inv_det
    off_x = -(i02 * gl + i12 * gy + i22 * gx) * inv_det
    val = vc + 0.5 * (gl * off_l + gy * off_y + gx * off_x)
    return val, off_l, off_y, off_x, (d, f, e_)


def _dense_scores(dog: jax.Array, cfg: SiftConfig, owned_rows):
    """Masked per-type candidate score planes + dense refinement record.

    Returns (s_max, s_min, val, off_l, off_y, off_x), all [B, S, He, We]
    (He/We = H/W rounded up to even).  Nonzero score entries are |DoG| at
    strict 26-neighbor extrema passing the pre-threshold + Hessian edge +
    interior tests; the record planes carry the Cramer subpixel solve of
    every pixel (garbage at non-candidates — only winner cells are read)."""
    B, L, H, W = dog.shape
    S = L - 2
    v = dog[:, 1 : S + 1]              # [B, S, H, W] candidate slices

    # --- dense extremum test over 26 neighbors (strict; ties rejected) ---
    m2x = _pool3x3(dog, jax.lax.max)
    m2n = _pool3x3(dog, jax.lax.min)
    m8x = _pool8(v, jax.lax.max)
    m8n = _pool8(v, jax.lax.min)
    nmax = jnp.maximum(jnp.maximum(m2x[:, 0:S], m2x[:, 2 : S + 2]), m8x)
    nmin = jnp.minimum(jnp.minimum(m2n[:, 0:S], m2n[:, 2 : S + 2]), m8n)
    pre = jnp.abs(v) > 0.8 * cfg.dog_threshold
    is_max = (v > 0) & (v > nmax) & pre
    is_min = (v < 0) & (v < nmin) & pre

    # --- dense subpixel-refinement record (its spatial-Hessian terms
    # double as the edge test's dyy/dxx/dxy) ---
    dgp = jnp.pad(dog.astype(jnp.float32), ((0, 0), (0, 0), (1, 1), (1, 1)))

    def q(dl, dy, dx):
        return dgp[:, 1 + dl : 1 + dl + S, 1 + dy : 1 + dy + H,
                   1 + dx : 1 + dx + W]

    val, off_l, off_y, off_x, (dyy, dxx, dxy) = cramer_record(
        q, bool(cfg.subpixel)
    )

    # --- dense Hessian edge test on the DoG slice ---
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = cfg.edge_threshold
    edge_ok = (det > 0) & (tr * tr / jnp.where(det > 0, det, 1.0) < (r + 1.0) ** 2 / r)

    # --- interior-only (3x3x3 patch must exist) ---
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    interior = (yy >= 1) & (yy <= H - 2) & (xx >= 1) & (xx <= W - 2)

    base_keep = edge_ok & interior[None, None]
    if owned_rows is not None:
        lo, hi = owned_rows
        base_keep &= (yy[None, None] >= lo) & (yy[None, None] < hi)

    He, We = H + (H % 2), W + (W % 2)
    # pack the pixel's 2x2-block corner index (y&1)*2 + (x&1) into the two
    # low mantissa bits (<= 2^-22 relative perturbation): after the 2x2 max
    # pool the winner's within-block position rides along in the top-k value,
    # so no post-top-k corner gather is needed.  Zeros stay exactly zero.
    par = (yy & 1) * 2 + (xx & 1)
    s_max = _pack_corner(jnp.abs(v) * (is_max & base_keep), par[None, None])
    s_min = _pack_corner(jnp.abs(v) * (is_min & base_keep), par[None, None])

    recs = (val, off_l, off_y, off_x)
    if (He, We) != (H, W):
        pad2 = ((0, 0), (0, 0), (0, He - H), (0, We - W))
        s_max = jnp.pad(s_max, pad2)
        s_min = jnp.pad(s_min, pad2)
        recs = tuple(jnp.pad(p, pad2) for p in recs)
    # score planes are ROW-POOLED here; the consumer pools the column pairs
    rp = lambda p: jax.lax.reduce_window(
        p, 0.0, jax.lax.max, (1, 1, 2, 1), (1, 1, 2, 1), "VALID"
    )
    return (rp(s_max), rp(s_min)) + recs


def _pack_corner(s: jax.Array, par: jax.Array) -> jax.Array:
    """Overwrite the two low mantissa bits of positive scores with `par`."""
    u = jax.lax.bitcast_convert_type(s.astype(jnp.float32), jnp.int32)
    u = jnp.where(s > 0, (u & ~3) | par, 0)
    return jax.lax.bitcast_convert_type(u, jnp.float32)


class OctaveWinners(NamedTuple):
    """Integer winner pixels of the pooled top-k, pre-refinement."""
    py: jax.Array      # [B, cap] int32 winner row
    px: jax.Array      # [B, cap] int32 winner col
    l: jax.Array       # [B, cap] int32 DoG slice in [1, S]
    cand: jax.Array    # [B, cap] bool (top-k slot holds a real candidate)


def detect_winners(
    dog: jax.Array, cfg: SiftConfig, cap: int, owned_rows=None,
) -> OctaveWinners:
    """Winners only (integer pixels of the pooled top-k, pre-refinement)."""
    win, _, _ = _winners_and_records(dog, cfg, cap, owned_rows)
    return win


def _winners_and_records(
    dog: jax.Array, cfg: SiftConfig, cap: int, owned_rows=None,
):
    """Dense scores -> 2x2-pooled top-k -> integer winner pixels.

    `owned_rows=(lo, hi)` restricts candidates to slab rows [lo, hi) — used
    by the spatially-sharded path so halo-region extrema neither consume
    top-k capacity nor get double-counted across shards.

    --- fixed-capacity compaction via EXACT 2x2-pooled top-k ---
    Within one extremum TYPE, strict 26-neighbor extrema are never 8-adjacent
    in a slice (a > all neighbors forbids an adjacent b > its neighbors), so
    each 2x2 block holds at most one MAXIMUM and one MINIMUM candidate.
    Pooling the two types separately and concatenating keeps top-k exact at
    half the sort size.  (A max and a min CAN be adjacent — pooling |DoG|
    jointly would drop one.)  The winner's within-block corner rides in the
    two low mantissa bits of the score (`_pack_corner`), so no post-top-k
    corner gather is needed.
    """
    bscore, recs, (Hs, Ws), (nb1, Hs2) = _octave_scores(dog, cfg, owned_rows)
    top, bidx = _run_topk(bscore, cap)
    win = _decode_topk(top, bidx, cap, nb1, Hs2, Ws)
    return win, recs, (Hs, Ws)


def _octave_scores(dog, cfg, owned_rows=None):
    """Dense scores + pooling only — the per-octave front half of
    `_winners_and_records`, split out so `detect_pyramid` can run the
    top-k of every octave before the merged record gather.  Returns
    (bscore [B, nb], records, (Hs, Ws), (nb1, Hs2))."""
    B, L, H, W = dog.shape
    S = L - 2
    s_max, s_min, r_val, r_ol, r_oy, r_ox = _dense_scores(dog, cfg, owned_rows)
    Hs2, Ws = s_max.shape[-2:]
    Hs = r_val.shape[-2]

    def pooled(score):
        return jax.lax.reduce_window(
            score, 0.0, jax.lax.max,
            window_dimensions=(1, 1, 1, 2), window_strides=(1, 1, 1, 2),
            padding="VALID",
        )

    nb1 = S * Hs2 * (Ws // 2)
    bscore = jnp.concatenate(
        [pooled(s_max).reshape(B, nb1), pooled(s_min).reshape(B, nb1)], axis=1
    )
    return bscore, (r_val, r_ol, r_oy, r_ox), (Hs, Ws), (nb1, Hs2)


def _run_topk(bscore, cap):
    """Fixed-capacity exact top-k of a [rows, n] pooled score matrix (score
    descending, lower index first on ties).  One `lax.top_k` per row set:
    on the H100 it beat splitting the 4K octave-0 row (12.4M entries, k =
    8192) into exact per-chunk top-k plus a merge at every chunk count
    tried (PERF.md)."""
    n = bscore.shape[1]
    k = min(cap, n)  # tiny octaves: fewer pooled entries than cap
    top, bidx = jax.lax.top_k(bscore, k)
    if k < cap:  # pad to the fixed capacity; zero scores are masked by `cand`
        top = jnp.pad(top, ((0, 0), (0, cap - k)))
        bidx = jnp.pad(bidx, ((0, 0), (0, cap - k)))
    return top, bidx


def _decode_topk(top, bidx, cap, nb1, Hs2, Ws):
    cand = top > 0.0
    bidx1 = bidx % nb1                               # drop the type axis
    l = bidx1 // (Hs2 * (Ws // 2)) + 1               # DoG slice index in [1, S]
    rem = bidx1 % (Hs2 * (Ws // 2))
    # winner pixel = block origin + the corner packed in the score mantissa
    corner = jax.lax.bitcast_convert_type(top, jnp.int32) & 3
    py = (rem // (Ws // 2)) * 2 + (corner >> 1)
    px = (rem % (Ws // 2)) * 2 + (corner & 1)
    # padded rows/cols can never win: their scores are 0 and cand masks them
    return OctaveWinners(py=py, px=px, l=l, cand=cand)


# The dense score pass already holds all 27 taps and emits the Cramer RECORD
# (val, off_l, off_y, off_x) per pixel, so the top-k tail gathers 4 record
# cells per winner instead of a 3x3x3 DoG patch.
N_REC = 4


def record_indices(win: OctaveWinners, S: int, Hs: int, Ws: int) -> jax.Array:
    """[B, 4*cap] flat indices of the winner's record cells in the
    field-stacked record planes reshaped to [B, 4 * S*Hs*Ws] (field-major:
    val | off_l | off_y | off_x; l is 1-based, records indexed by slice
    l-1).  Indices are in range by construction: `l` is clamped to
    [0, S-1] here, and py/px are bounded by the score-plane decode
    (py < Hs, px < Ws) — there is no py/px clamp.  Padded winners are
    masked by `cand` downstream (refine_records), not by indexing."""
    vol = S * Hs * Ws
    cell = (jnp.clip(win.l - 1, 0, S - 1)) * (Hs * Ws) + win.py * Ws + win.px
    return jnp.concatenate([cell + f * vol for f in range(N_REC)], axis=1)


def refine_records(
    rec: jax.Array, win: OctaveWinners, cfg: SiftConfig, H: int, W: int
) -> OctaveKeypoints:
    """rec: [B, 4, cap] gathered (val, off_l, off_y, off_x) records of each
    winner (the dense Cramer solve ran in the score pass) -> offset/contrast/
    border validity tests + derived scale.  H, W are the TRUE image dims."""
    S = cfg.dog_levels
    py, px, l, cand = win.py, win.px, win.l, win.cand
    val, off_l, off_y, off_x = rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]

    if cfg.subpixel:
        off_ok = (
            (jnp.abs(off_l) <= 1.5) & (jnp.abs(off_y) <= 1.5)
            & (jnp.abs(off_x) <= 1.5)
        )
        # a level offset beyond +-0.5 means the extremum belongs to the
        # neighboring DoG slice; clamp so refined sigma stays within the
        # bound the static orientation/descriptor windows are sized for
        # (core/scalespace.py::max_detect_sigma) — oracle does the same
        off_l = jnp.clip(off_l, -0.5, 0.5)
    else:
        off_ok = jnp.ones_like(val, dtype=bool)

    fy = py.astype(jnp.float32) + off_y
    fx = px.astype(jnp.float32) + off_x
    fl = l.astype(jnp.float32) + off_l

    bd = float(cfg.border)
    border_ok = (fy >= bd) & (fy < H - bd) & (fx >= bd) & (fx < W - bd)
    contrast_ok = jnp.abs(val) >= cfg.dog_threshold
    mask = cand & off_ok & border_ok & contrast_ok

    sigma = cfg.sigma0 * jnp.exp2(fl / S)
    grad_level = jnp.clip(jnp.round(fl).astype(jnp.int32), 1, S)

    # `-sign` flag parity (GlobalUtil::_KeepExtremumSign ⚠): keep the SIGNED
    # refined DoG value so the output stage can mark minima (dark blobs) with
    # a negated sigma; ranking sites take |response| when keep_sign is on.
    resp = val if cfg.keep_sign else jnp.abs(val)
    return OctaveKeypoints(
        y=fy, x=fx, level=fl, grad_level=grad_level, sigma=sigma,
        response=resp, mask=mask,
    )


def detect_octave(
    oc: Octave, cfg: SiftConfig, cap: int, owned_rows=None,
) -> OctaveKeypoints:
    """Single-octave detection (see `detect_winners` for the semantics).
    The multi-octave single-chip path uses `detect_pyramid`, which merges the
    per-octave record gathers into one call."""
    dog = oc.dog                       # [B, S+2, H, W]
    B, L, H, W = dog.shape
    S = L - 2
    win, recs, (Hs, Ws) = _winners_and_records(dog, cfg, cap, owned_rows)
    ridx = record_indices(win, S, Hs, Ws)
    rf = jnp.concatenate([r.reshape(B, -1) for r in recs], axis=1)
    rec = jnp.take_along_axis(rf, ridx, axis=1).reshape(B, N_REC, -1)
    return refine_records(rec, win, cfg, H, W)


def detect_pyramid(pyr, cfg: SiftConfig, caps=None):
    """Detection over ALL octaves with the record gathers of every octave
    merged into ONE take_along_axis.  Returns a list of per-octave
    `OctaveKeypoints`, identical to calling `detect_octave` per octave."""
    caps = caps or [cfg.octave_cap(o) for o in range(len(pyr))]
    B = pyr[0].dog.shape[0]
    # phase 1: dense scores + pooled candidate arrays for every octave
    bscores, recss, hw, metas, dims = [], [], [], [], []
    for oc in pyr:
        _, L, H, W = oc.dog.shape
        bscore, recs, (Hs, Ws), meta = _octave_scores(oc.dog, cfg)
        bscores.append(bscore)
        recss.append(recs)
        hw.append((Hs, Ws, L - 2))
        metas.append(meta)
        dims.append((H, W))

    # phase 2: exact top-k, one call per octave (zero-padding the tail
    # octaves into one batched call measured slower on the H100, PERF.md)
    tops, bidxs = zip(*[_run_topk(b, c) for b, c in zip(bscores, caps)])

    # phase 3: decode winners + merge the record gathers into ONE call
    wins, ridxs, flats = [], [], []
    off = 0
    for i, cap in enumerate(caps):
        Hs, Ws, S = hw[i]
        nb1, Hs2 = metas[i]
        win = _decode_topk(tops[i], bidxs[i], cap, nb1, Hs2, Ws)
        wins.append(win)
        ridxs.append(record_indices(win, S, Hs, Ws) + off)
        flats.append(
            jnp.concatenate([r.reshape(B, -1) for r in recss[i]], axis=1))
        off += N_REC * S * Hs * Ws
    rall = jnp.take_along_axis(
        jnp.concatenate(flats, axis=1), jnp.concatenate(ridxs, axis=1), axis=1
    )

    outs, col = [], 0
    for (H, W), cap, win in zip(dims, caps, wins):
        rec = rall[:, col : col + N_REC * cap].reshape(B, N_REC, cap)
        col += N_REC * cap
        outs.append(refine_records(rec, win, cfg, H, W))
    return outs

