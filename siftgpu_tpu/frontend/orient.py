"""Orientation assignment: 36-bin gradient histogram, <=2 peaks >= 80% of max.

Replacement for `ProgramCU::ComputeOrient` (SURVEY.md §2.4 item 5 ⚠)
and for `SiftPyramid::ReshapeFeatureListCPU`: the reference downloads keypoints
to the host to split multi-orientation features; here every keypoint statically
owns `max_orientations` slots and the split is just a validity mask — no
device->host round trip (SURVEY §3.1).

Static-shape strategy: a fixed (2R+1)^2 window (R covers the max refined sigma)
is gathered per keypoint with `dynamic_slice`; the per-keypoint circular
support and Gaussian weight are applied as masks.  Histogram accumulation is a
chunked one-hot contraction (no scatter).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core.config import SiftConfig
from .detect import OctaveKeypoints

__all__ = ["GradStack", "gradient_stack", "compute_orientations", "exp_window"]

_TWO_PI = 6.283185307179586

# degree-7 least-squares fit of exp(x) on [-4.75, 0] (abs err <= 6.3e-5,
# rel err at the in-circle extreme x = -rad_f^2/2 = -4.5: 0.2%).  A window
# weight needs no exp-grade accuracy; the NumPy oracle keeps true exp.
_EXPW = (
    2.1755081222e-05, 5.1727565826e-04, 5.5559910437e-03, 3.6198773900e-02,
    1.6038511456e-01, 4.9620069315e-01, 9.9901960879e-01, 9.9993781360e-01,
)


def exp_window(x):
    """Polynomial stand-in for exp(x) on the Gaussian-window range
    [-rad_f^2/2, 0]; inputs are clamped (out-of-circle pixels evaluate it
    too before their mask applies, at arbitrarily negative x)."""
    x = jnp.maximum(x, -4.75)
    acc = jnp.full_like(x, _EXPW[0])
    for c in _EXPW[1:]:
        acc = acc * x + c
    return acc


class GradStack(NamedTuple):
    """Gradients of Gaussian levels 1..S, zero-padded to at least the
    orientation window so window slices are always in range.

    For spatially-sharded slabs (parallel/spatial.py), `y0` is the global row
    of slab row 0 (may be a traced per-shard scalar) and `global_h` the full
    image height at this octave; window/sample pixels outside the TRUE image
    are masked exactly like the single-chip path excludes them."""
    gx: jax.Array      # [B, S, Hp, Wp]
    gy: jax.Array      # [B, S, Hp, Wp]
    h: int             # slab (unpadded) height
    w: int             # width
    y0: jax.Array      # [] global row offset of slab row 0 (0 on single chip)
    global_h: int      # full-image height at this octave


def gradient_stack(
    gauss: jax.Array, cfg: SiftConfig, y0: jax.Array | None = None,
    global_h: int | None = None,
) -> GradStack:
    """gauss: [B, S+3, H, W] -> central-difference grads of levels 1..S."""
    g = gauss[:, 1 : cfg.dog_levels + 1].astype(jnp.float32)
    B, S, H, W = g.shape

    gp = jnp.pad(g, ((0, 0), (0, 0), (1, 1), (1, 1)), mode="edge")
    gx = 0.5 * (gp[:, :, 1 : H + 1, 2:] - gp[:, :, 1 : H + 1, :W])
    gy = 0.5 * (gp[:, :, 2:, 1 : W + 1] - gp[:, :, :H, 1 : W + 1])
    # edge columns/rows use one-sided differences (matches oracle `gradients`)
    gx = gx.at[:, :, :, 0].set(g[:, :, :, 1] - g[:, :, :, 0])
    gx = gx.at[:, :, :, -1].set(g[:, :, :, -1] - g[:, :, :, -2])
    gy = gy.at[:, :, 0, :].set(g[:, :, 1, :] - g[:, :, 0, :])
    gy = gy.at[:, :, -1, :].set(g[:, :, -1, :] - g[:, :, -2, :])
    if y0 is not None and global_h is not None:
        # spatially-sharded slab: the TRUE image boundary rows sit interior to
        # the slab next to replicated halo rows, so the central difference
        # there evaluates to exactly half the single-chip one-sided diff — x2
        # restores bit-parity (tests/test_parallel.py).
        grow = jax.lax.broadcasted_iota(jnp.int32, (H, 1), 0) + y0
        factor = jnp.where((grow == 0) | (grow == global_h - 1), 2.0, 1.0)
        gy = gy * factor[None, None]

    win = 2 * cfg.orient_window_radius + 1
    ph, pw = max(0, win - H), max(0, win - W)
    if ph or pw:
        gx = jnp.pad(gx, ((0, 0), (0, 0), (0, ph), (0, pw)))
        gy = jnp.pad(gy, ((0, 0), (0, 0), (0, ph), (0, pw)))
    # f32 storage: rounding the planes to bf16 turns last-bit differences of
    # the pyramid (another summation order on another device) into 2^-8
    # steps, which moved an ill-placed keypoint's descriptor by 3 uint8 steps
    return GradStack(
        gx=gx, gy=gy, h=H, w=W,
        y0=jnp.zeros((), jnp.int32) if y0 is None else y0,
        global_h=H if global_h is None else global_h,
    )


def _hist_onehot(w: jax.Array, bins: jax.Array, nb: int, chunk: int = 128) -> jax.Array:
    """sum_p w[..., p] * onehot(bins[..., p], nb) without materializing the
    full one-hot: scan over pixel chunks. w, bins: [B, K, P] -> [B, K, nb]."""
    B, K, P = w.shape
    pad = (-P) % chunk
    if pad:
        w = jnp.pad(w, ((0, 0), (0, 0), (0, pad)))
        bins = jnp.pad(bins, ((0, 0), (0, 0), (0, pad)))
    nc = w.shape[-1] // chunk
    wc = jnp.moveaxis(w.reshape(B, K, nc, chunk), 2, 0)
    bc = jnp.moveaxis(bins.reshape(B, K, nc, chunk), 2, 0)

    def body(h, args):
        wi, bi = args
        oh = jax.nn.one_hot(bi, nb, dtype=wi.dtype)          # [B, K, chunk, nb]
        return h + jnp.einsum(
            "bkc,bkcn->bkn", wi, oh, precision=jax.lax.Precision.HIGHEST
        ), None

    h0 = jnp.zeros((B, K, nb), w.dtype)
    h, _ = jax.lax.scan(body, h0, (wc, bc))
    return h


def compute_orientations(
    grads: GradStack, kp: OctaveKeypoints, cfg: SiftConfig
) -> Tuple[jax.Array, jax.Array]:
    """Returns (theta [B, K, max_orientations], valid [B, K, max_orientations]).

    Slot 0 always carries an angle (0.0 fallback if the histogram is empty);
    its validity equals the keypoint mask.  Higher slots are valid only when a
    distinct peak >= peak_ratio * max exists.
    """
    B, K = kp.y.shape
    R = cfg.orient_window_radius
    win = 2 * R + 1
    nb = cfg.orientation_bins
    Hp, Wp = grads.gx.shape[-2:]

    iy = jnp.round(kp.y).astype(jnp.int32)
    ix = jnp.round(kp.x).astype(jnp.int32)
    sy = jnp.clip(iy - R, 0, Hp - win)
    sx = jnp.clip(ix - R, 0, Wp - win)
    lvl = kp.grad_level - 1                                   # index into S axis

    def slice_one(g_b, l1, y1, x1):
        return jax.lax.dynamic_slice(g_b, (l1, y1, x1), (1, win, win))[0]

    gather = jax.vmap(jax.vmap(slice_one, in_axes=(None, 0, 0, 0)))
    wx = gather(grads.gx, lvl, sy, sx)                        # [B, K, win, win]
    wy = gather(grads.gy, lvl, sy, sx)

    # true offsets of each window pixel from the refined center
    ar = jnp.arange(win, dtype=jnp.float32)
    oy = sy[..., None].astype(jnp.float32) + ar - kp.y[..., None]   # [B, K, win]
    ox = sx[..., None].astype(jnp.float32) + ar - kp.x[..., None]
    r2 = oy[..., :, None] ** 2 + ox[..., None, :] ** 2        # [B, K, win, win]

    sw = cfg.orientation_sigma_factor * kp.sigma              # [B, K]
    radius = cfg.orientation_radius_factor * sw
    wgt = exp_window(-r2 / (2.0 * (sw**2)[..., None, None]))
    wgt = jnp.where(r2 <= (radius**2)[..., None, None], wgt, 0.0)
    # exclude pixels outside the TRUE image (no-op single chip; exact for
    # spatially sharded slabs whose halos extend past the image boundary)
    gy_row = sy[..., None].astype(jnp.int32) + jnp.arange(win, dtype=jnp.int32)
    row_ok = (gy_row + grads.y0 >= 0) & (gy_row + grads.y0 < grads.global_h)
    wgt = wgt * row_ok[..., :, None]

    mag = jnp.sqrt(wx * wx + wy * wy)
    ang = jnp.arctan2(wy, wx) % _TWO_PI
    bins = jnp.clip((ang * (nb / _TWO_PI)).astype(jnp.int32), 0, nb - 1)

    P = win * win
    hist = _hist_onehot(
        (wgt * mag).reshape(B, K, P), bins.reshape(B, K, P), nb
    )                                                          # [B, K, nb]

    for _ in range(6):  # circular box smoothing x6 (matches oracle)
        hist = (jnp.roll(hist, 1, -1) + hist + jnp.roll(hist, -1, -1)) / 3.0

    left = jnp.roll(hist, 1, -1)
    right = jnp.roll(hist, -1, -1)
    mx = jnp.max(hist, axis=-1, keepdims=True)
    is_peak = (hist > left) & (hist > right) & (
        hist >= cfg.orientation_peak_ratio * mx
    ) & (mx > 0)
    peak_val = jnp.where(is_peak, hist, -jnp.inf)
    top, idx = jax.lax.top_k(peak_val, cfg.max_orientations)  # [B, K, n]

    li = jnp.take_along_axis(hist, (idx - 1) % nb, axis=-1)
    ri = jnp.take_along_axis(hist, (idx + 1) % nb, axis=-1)
    ci = jnp.take_along_axis(hist, idx, axis=-1)
    denom = li - 2.0 * ci + ri
    d = jnp.where(jnp.abs(denom) < 1e-12, 0.0, 0.5 * (li - ri) / denom)
    theta = (_TWO_PI * (idx.astype(jnp.float32) + 0.5 + d) / nb) % _TWO_PI

    has_peak = jnp.isfinite(top)
    theta = jnp.where(has_peak, theta, 0.0)
    valid = has_peak & kp.mask[..., None]
    # slot 0 fallback: degenerate histogram still yields one theta=0 keypoint
    valid = valid.at[..., 0].set(kp.mask)
    return theta, valid
