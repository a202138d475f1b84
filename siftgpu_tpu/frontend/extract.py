"""Full feature extraction: the `SiftPyramid::RunSIFT` template method analog.

Stage contract preserved from the reference (SURVEY.md §3.1 ⚠):
  BuildPyramid -> DetectKeypointsEX -> GenerateFeatureList ->
  GetFeatureOrientations -> (ReshapeFeatureListCPU) -> descriptors ->
  DownloadKeypoints
— but with zero device->host boundaries: every stage operates on
fixed-capacity padded buffers with validity masks, and the whole pipeline is
one traced XLA program.  `extract_features` is jit-compiled with the frozen
`SiftConfig` as a static argument; the batch axis is the outer axis and can be
sharded over a `data` mesh axis (SURVEY §7.1).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.config import SiftConfig
from . import describe, detect, orient, pyramid

__all__ = [
    "Features", "extract_features", "extract_features_jit",
    "extract_features_obo",
]


class Features(NamedTuple):
    """Padded per-image feature buffers (the `GetFeatureVector` analog).

    Keypoint fields are in INPUT-image coordinates (octave scaling applied,
    `DownloadKeypoints` coordinate-fixup analog ⚠ SURVEY §2.1).
    """

    x: jax.Array         # [B, K] float32
    y: jax.Array         # [B, K]
    sigma: jax.Array     # [B, K]
    theta: jax.Array     # [B, K] radians in [0, 2pi)
    response: jax.Array  # [B, K] |DoG| at the keypoint (signed if keep_sign)
    octave: jax.Array    # [B, K] int32 (index into cfg octaves, 0-based)
    desc: jax.Array      # [B, K, 128] uint8
    mask: jax.Array      # [B, K] bool

    @property
    def count(self):
        return self.mask.sum(axis=-1).astype(jnp.int32)

    @property
    def keypoints(self):
        """[B, K, 4] (x, y, sigma, theta) — SiftKeypoint struct layout ⚠."""
        return jnp.stack([self.x, self.y, self.sigma, self.theta], axis=-1)


def octave_candidates(
    oc, cfg: SiftConfig, cap: int, y0=None, global_h=None, owned_rows=None,
    kp=None,
):
    """Detect + orient + describe one octave.  Returns a dict of [B, cap *
    max_orientations] arrays in OCTAVE-LOCAL coordinates (y/x relative to the
    given slab; `y0`/`global_h` thread global-image bounds through for
    spatially sharded slabs).  Shared by the single-chip and spatial paths.
    `kp` supplies pre-detected keypoints (the single-chip path detects all
    octaves at once via `detect.detect_pyramid` to merge gather calls)."""
    B = oc.gauss.shape[0]
    if kp is None:
        kp = detect.detect_octave(oc, cfg, cap, owned_rows=owned_rows)
    grads = orient.gradient_stack(oc.gauss, cfg, y0=y0, global_h=global_h)
    n = cfg.max_orientations

    def dup(a):
        return jnp.repeat(a[..., None], n, axis=-1).reshape(B, cap * n)

    y2, x2, s2, gl2, r2 = map(dup, (kp.y, kp.x, kp.sigma, kp.grad_level, kp.response))

    theta, valid = orient.compute_orientations(grads, kp, cfg)  # [B,cap,n]
    th2 = theta.reshape(B, cap * n)
    m2 = valid.reshape(B, cap * n)
    d2 = describe.compute_descriptors(grads, y2, x2, s2, th2, gl2, cfg)
    return dict(y=y2, x=x2, sigma=s2, theta=th2, response=r2, mask=m2, desc=d2)


def prefilter_candidates(kps, cfg: SiftConfig):
    """Mask out candidates that provably cannot reach the final top-K.

    `assemble_features` keeps the cfg.max_keypoints highest-response
    orientation SLOTS.  Every valid candidate contributes at least one valid
    slot at exactly its own response (the slot-0 theta=0 fallback in
    `orient.compute_orientations`), so a
    candidate whose response is strictly below the K-th largest valid
    candidate response is outranked by >= K slots and can never be selected
    — masking it changes nothing downstream (ties kept via >=).

    Survivors are front-compacted per octave (stable argsort on the mask,
    relative order kept, so the final output stays bit-identical).  The
    orientation/descriptor stages still process every slot, so the mask
    saves no work on the current XLA route (PERF.md, open questions).
    """
    K = cfg.max_keypoints
    rank = (lambda r: jnp.abs(r)) if cfg.keep_sign else (lambda r: r)
    resp = jnp.concatenate(
        [jnp.where(k.mask, rank(k.response), -jnp.inf) for k in kps], axis=1
    )
    if resp.shape[1] <= K:
        return kps
    thr = jax.lax.top_k(resp, K)[0][:, -1:]          # [B, 1] K-th response
    thr = jnp.where(jnp.isfinite(thr), thr, -jnp.inf)  # < K valid: keep all
    masks = [k.mask & (rank(k.response) >= thr) for k in kps]

    # all octaves and all 7 candidate fields ride ONE take_along_axis
    def stackf(k, m):
        return jnp.stack(
            [k.y, k.x, k.level, k.grad_level.astype(jnp.float32),
             k.sigma, k.response, m.astype(jnp.float32)], axis=1
        )                                            # [B, 7, cap]

    allf = jnp.concatenate([stackf(k, m) for k, m in zip(kps, masks)], axis=2)
    caps = [k.mask.shape[1] for k in kps]
    idx_parts, off = [], 0
    for m, cap in zip(masks, caps):
        order = jnp.argsort((~m).astype(jnp.int32), axis=1, stable=True)
        idx_parts.append(order + off)
        off += cap
    idx = jnp.concatenate(idx_parts, axis=1)         # [B, total]
    g = jnp.take_along_axis(allf, idx[:, None, :], axis=2)
    outs, off = [], 0
    for k, cap in zip(kps, caps):
        s = g[:, :, off : off + cap]
        off += cap
        outs.append(
            k._replace(
                y=s[:, 0], x=s[:, 1], level=s[:, 2],
                grad_level=s[:, 3].astype(jnp.int32), sigma=s[:, 4],
                response=s[:, 5], mask=s[:, 6] > 0.5,
            )
        )
    return outs


def assemble_features(parts, cfg: SiftConfig) -> Features:
    """parts: per-octave dicts with IMAGE-coordinate fields + 'octave'.
    Concatenates and applies the global fixed-capacity top-k selection."""
    cat = lambda k: jnp.concatenate([p[k] for p in parts], axis=1)
    x, y, s, th, r = map(cat, ("x", "y", "sigma", "theta", "response"))
    m = cat("mask")
    oc_ = cat("octave")
    d = cat("desc")

    # global fixed-capacity selection by response (the -tc truncation analog)
    K = cfg.max_keypoints
    if m.shape[1] < K:  # tiny images: fewer candidates than the cap
        pad = K - m.shape[1]
        pf = lambda a: jnp.pad(a, ((0, 0), (0, pad)))
        x, y, s, th, r = map(pf, (x, y, s, th, r))
        oc_ = pf(oc_)
        m = jnp.pad(m, ((0, 0), (0, pad)), constant_values=False)
        d = jnp.pad(d, ((0, 0), (0, pad), (0, 0)))
    resp = jnp.abs(r) if cfg.keep_sign else r
    # octave bias for -tc1/-tc2: the refined |response| is bounded by
    # |vc| + 0.5*sum_i |g_i|*|off_i| <= 1 + 0.5*3*1*1.5 = 3.25 (DoG of
    # [0, 1] images gives |vc| <= 1, |g_i| <= 1; the refinement's off_ok
    # clamp gives |off_i| <= 1.5 — widen that clamp and this bias must be
    # re-derived).  4.0 > 3.25 keeps octaves totally ordered while the f32
    # ulp at the biased score (~6e-6 at 12 octaves) stays far below response
    # resolution — a large bias (1e4) would quantize away the response
    # tie-break within an octave
    if cfg.truncate_method == 1:    # -tc1: fine octaves first (small scale)
        resp = resp - oc_.astype(resp.dtype) * 4.0
    elif cfg.truncate_method == 2:  # -tc2: coarse octaves first (large scale)
        resp = resp + oc_.astype(resp.dtype) * 4.0
    score = jnp.where(m, resp, -jnp.inf)
    _, idx = jax.lax.top_k(score, K)
    take = lambda a: jnp.take_along_axis(a, idx, axis=1)
    mask = take(m)
    return Features(
        x=take(x), y=take(y), sigma=take(s), theta=take(th),
        response=take(r), octave=take(oc_),
        desc=jnp.take_along_axis(d, idx[..., None], axis=1),
        mask=mask,
    )


def to_image_coords(cand: dict, cfg: SiftConfig, o: int, B: int) -> dict:
    """Octave-local candidate dict -> image-coordinate dict (+ octave field)."""
    scale = cfg.octave_scale(o)
    shift = 0.5 if cfg.lowe_origin else 0.0
    out = dict(cand)
    out["x"] = (cand["x"] + shift) * scale
    out["y"] = (cand["y"] + shift) * scale
    out["sigma"] = cand["sigma"] * scale
    if cfg.keep_sign:
        # `-sign` parity ⚠: DoG minima (dark features) download a negated
        # scale; orientation/descriptor stages used the positive sigma above
        out["sigma"] = jnp.where(cand["response"] < 0, -out["sigma"], out["sigma"])
    out["octave"] = jnp.full(cand["mask"].shape, o, jnp.int32)
    return out


def extract_features(images: jax.Array, cfg: SiftConfig) -> Features:
    """images: [B, H, W] grayscale float in [0, 1] -> Features with K =
    cfg.max_keypoints, ordered by response (desc), padded entries masked."""
    B = images.shape[0]
    with jax.named_scope("sift.pyramid"):
        pyr = pyramid.build_pyramid(images, cfg)
    with jax.named_scope("sift.detect"):
        kps = detect.detect_pyramid(pyr, cfg)  # merged cross-octave gather
        if cfg.truncate_method == 0:  # prefilter assumes response-rank selection
            kps = prefilter_candidates(kps, cfg)  # exact top-K pre-selection
    parts = []
    for o, oc in enumerate(pyr):
        with jax.named_scope(f"sift.describe.oct{o}"):
            cand = octave_candidates(oc, cfg, cfg.octave_cap(o), kp=kps[o])
        parts.append(to_image_coords(cand, cfg, o, B))
    with jax.named_scope("sift.assemble"):
        return assemble_features(parts, cfg)


@partial(jax.jit, static_argnums=1)
def extract_features_jit(images: jax.Array, cfg: SiftConfig) -> Features:
    return extract_features(images, cfg)


# ---------------- octave-by-octave mode (`_ProcessOBO` analog) ----------------

@partial(jax.jit, static_argnums=1)
def _obo_prep_jit(images: jax.Array, cfg: SiftConfig) -> jax.Array:
    """Input conditioning + initial blur -> octave 0's Gaussian level 0."""
    x = images.astype(jnp.dtype(cfg.pyramid_dtype))
    if cfg.upsampled:
        x = pyramid.upsample2x(x)
    else:
        for _ in range(cfg.first_octave):
            x = pyramid.downsample2x(x)
    return pyramid.blur_separable(
        x, cfg.gaussian_taps(cfg.initial_blur_sigma())
    )


@partial(jax.jit, static_argnums=(1, 2))
def _obo_octave_jit(base: jax.Array, cfg: SiftConfig, o: int):
    """One octave end-to-end: blur levels -> DoG -> detect -> orient/describe.
    Returns (image-coordinate candidate dict, next octave's level-0 seed).
    Only `base` [B, H_o, W_o] and the (small) candidate buffers live across
    dispatches, so peak memory is ONE octave's working set."""
    B = base.shape[0]
    levels = [base]
    for s in cfg.incremental_sigmas():
        levels.append(
            pyramid.blur_separable(
                levels[-1], cfg.gaussian_taps(float(s))
            )
        )
    gauss = jnp.stack(levels, axis=1)
    oc = pyramid.Octave(gauss=gauss, dog=gauss[:, 1:] - gauss[:, :-1])
    cand = octave_candidates(oc, cfg, cfg.octave_cap(o))
    part = to_image_coords(cand, cfg, o, B)
    return part, pyramid.downsample2x(levels[cfg.dog_levels])


@partial(jax.jit, static_argnums=1)
def _obo_assemble_jit(parts, cfg: SiftConfig) -> Features:
    return assemble_features(list(parts), cfg)


def extract_features_obo(images: jax.Array, cfg: SiftConfig) -> Features:
    """Memory-capped extraction: one dispatch per octave instead of one fused
    program (`GlobalUtil::_ProcessOBO` analog ⚠ SURVEY §5.7 — the reference
    processes octaves one-by-one to fit large images in texture memory).

    Peak device memory is bounded by octave 0's working set (~the fused
    program holds several octaves' pyramids + gradient stacks concurrently,
    scheduler-dependent); the cost is per-dispatch overhead and no
    cross-octave fusion/prefilter.  Outputs are IDENTICAL to
    `extract_features`: the per-octave candidate sets are the same, the
    cross-octave `prefilter_candidates` is output-preserving (only a work
    saver), and the final assembly applies the same top-K.
    """
    base = _obo_prep_jit(images, cfg)
    parts = []
    for o in range(cfg.octaves):
        part, base = _obo_octave_jit(base, cfg, o)
        parts.append(part)
    return _obo_assemble_jit(tuple(parts), cfg)
