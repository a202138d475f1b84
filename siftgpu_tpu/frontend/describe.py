"""128-D SIFT descriptor: rotated 16x16 bilinear resample + trilinear binning.

Replacement for `ProgramCU::ComputeDescriptor`/`NormalizeDescriptor`
(SURVEY.md §2.4 item 6 ⚠).  The reference iterates over the (sigma-dependent,
dynamically sized) pixel support of each 4x4 cell; this formulation
resamples the gradient field on a FIXED G x G grid (G = 16) rotated to the
keypoint orientation, spaced 3*sigma/G_cell pixels — the standard GPU-SIFT
variant (static shapes, pure gathers + matmuls).

Because the sample grid is fixed in cell units, the spatial bilinear weights
(wr, wc) and the Gaussian window (gw) are CONSTANT [G, 4] / [G, G] matrices:
binning reduces to mag -> 8-way orientation split -> one constant
contraction.  Only the gradient gather and the relative angle depend on the
keypoint.

Quantization: clamp(floor(512 * v + 0.5), 0, 255) after normalize -> clip
0.2 -> renormalize (reference convention, SURVEY §2.4).
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import SiftConfig
from .orient import GradStack

__all__ = ["compute_descriptors", "finalize_descriptors"]

_TWO_PI = 6.283185307179586


@lru_cache(maxsize=None)
def _grid_constants(G: int, D: int, spc: int):
    """Constant sample-grid tensors: (u, v [G], wr/wc [G, D], gw [G, G])."""
    half = (G - 1) / 2.0
    t = np.arange(G) - half                       # grid coords, sample units
    cell = t / spc + (D - 1) / 2.0                # continuous cell coordinate
    w = np.zeros((G, D), np.float32)
    c0 = np.floor(cell).astype(int)
    fc = (cell - c0).astype(np.float32)
    for i in range(G):
        if 0 <= c0[i] < D:
            w[i, c0[i]] += 1.0 - fc[i]
        if 0 <= c0[i] + 1 < D:
            w[i, c0[i] + 1] += fc[i]
    sig = D / 2.0
    r = (cell - (D - 1) / 2.0) ** 2
    gw = np.exp(-(r[:, None] + r[None, :]) / (2.0 * sig * sig)).astype(np.float32)
    return t.astype(np.float32), w, gw


def _sample_coords(y, x, sigma, theta, cfg: SiftConfig):
    """Rotated sample-grid coordinates. y..theta: [B, C] -> py, px [B, C, G, G]."""
    G = cfg.descriptor_grid
    t, _, _ = _grid_constants(G, cfg.descriptor_width, cfg.descriptor_samples_per_cell)
    t = jnp.asarray(t)
    spc = cfg.descriptor_spacing * sigma / cfg.descriptor_samples_per_cell  # [B,C]
    u = t[None, None, None, :] * spc[..., None, None]      # [B, C, 1, G] (cols)
    v = t[None, None, :, None] * spc[..., None, None]      # [B, C, G, 1] (rows)
    ct = jnp.cos(theta)[..., None, None]
    st = jnp.sin(theta)[..., None, None]
    px = x[..., None, None] + ct * u - st * v              # [B, C, G, G]
    py = y[..., None, None] + st * u + ct * v
    return py, px


def _bilerp_xla(grads: GradStack, py, px, lvl):
    """Gather-based bilinear sampling. -> sgx, sgy."""
    B, C, G, _ = py.shape
    Hp, Wp = grads.gx.shape[-2:]
    x0 = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, Wp - 1)
    y0 = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, Hp - 1)
    x1 = jnp.minimum(x0 + 1, Wp - 1)
    y1 = jnp.minimum(y0 + 1, Hp - 1)
    fx = jnp.clip(px - x0, 0.0, 1.0)
    fy = jnp.clip(py - y0, 0.0, 1.0)
    base = (lvl[..., None, None] * Hp * Wp).astype(jnp.int32)  # [B, C, 1, 1]
    gxf = grads.gx.reshape(B, -1)
    gyf = grads.gy.reshape(B, -1)

    def bilerp(flat):
        def g(yi, xi):
            idx = (base + yi * Wp + xi).reshape(B, -1)
            return jnp.take_along_axis(flat, idx, axis=1).reshape(B, C, G, G)
        return (
            g(y0, x0) * (1 - fy) * (1 - fx)
            + g(y0, x1) * (1 - fy) * fx
            + g(y1, x0) * fy * (1 - fx)
            + g(y1, x1) * fy * fx
        )

    return bilerp(gxf), bilerp(gyf)


def _descriptor_chunk(
    grads: GradStack, y, x, sigma, theta, lvl, cfg: SiftConfig,
):
    """Raw (pre-normalization) descriptors for a chunk. y..lvl: [B, C]."""
    G = cfg.descriptor_grid
    B, C = y.shape

    py, px = _sample_coords(y, x, sigma, theta, cfg)

    # in-bounds test in GLOBAL image coordinates (y0/global_h handle spatially
    # sharded slabs; on a single chip y0 = 0 and global_h = h)
    py_g = py + grads.y0
    inb = (px >= 0) & (px <= grads.w - 1) & (py_g >= 0) & (py_g <= grads.global_h - 1)

    sgx, sgy = _bilerp_xla(grads, py, px, lvl)
    sgx = (sgx * inb).reshape(B, C, G * G)
    sgy = (sgy * inb).reshape(B, C, G * G)
    return _bin_chunk_fast(sgx, sgy, theta, cfg)


@lru_cache(maxsize=None)
def _w2_constant(G: int, D: int, spc: int) -> np.ndarray:
    """[G2, D*D] fused row x col spatial-tent matrix: W2[g, r*D+c] =
    wr[i(g), r] * wc[j(g), c] — collapses a double [G, D] contraction over
    rows and columns into ONE G2-contraction."""
    _, wrc, _ = _grid_constants(G, D, spc)
    return np.einsum("ir,jc->ijrc", wrc, wrc).reshape(G * G, D * D)


def _bin_chunk_fast(sgx, sgy, theta, cfg: SiftConfig):
    """Descriptor binning: circular-tent orientation weights + a single
    [G2, D*D] contraction (tests/test_describe.py checks it against a
    golden one-hot body).

    The adjacent-bin soft assign w(o0) = 1-fo, w(o0+1 mod NB) = fo is
    exactly relu(1 - circular_distance(ob, bin)) — no floor/one-hot compare
    chain; the row/col cell tents collapse into the constant `_w2_constant`
    so cell binning is one G2-contraction per orientation channel, in f32
    at HIGHEST on every platform.  (A bf16 contraction measured 13-23%
    faster on the H100 but moves ~1.2% of descriptor elements by one uint8
    step; that was not worth ~0.2 ms of a 5-15 ms extraction, PERF.md.)
    Wrap-edge semantics: ob == NB (fp rounding of ang ~ 2pi) lands its
    weight on bin 0 — the oracle's `floor(ob) % NB` (oracle/sift_cpu.py),
    where the golden body's clip keeps it on bin NB-1.
    """
    B, C, G2 = sgx.shape
    NB = cfg.descriptor_bins
    D = cfg.descriptor_width
    G = cfg.descriptor_grid
    _, _, gw = _grid_constants(G, D, cfg.descriptor_samples_per_cell)
    gwf = jnp.asarray(gw).reshape(G2)
    mag = jnp.sqrt(sgx * sgx + sgy * sgy) * gwf
    ang = (jnp.arctan2(sgy, sgx) - theta[..., None]) % _TWO_PI
    ob = ang * (NB / _TWO_PI)
    bins = jnp.arange(NB, dtype=jnp.float32)[:, None]
    ad = jnp.abs(ob[..., None, :] - bins)              # [B, C, NB, G2]
    w = jnp.maximum(1.0 - jnp.minimum(ad, NB - ad), 0.0)
    mo = mag[..., None, :] * w
    W2 = jnp.asarray(_w2_constant(G, D, cfg.descriptor_samples_per_cell))
    desc = jax.lax.dot_general(
        mo, W2, (((3,), (0,)), ((), ())), precision=jax.lax.Precision.HIGHEST,
    )                                                  # [B, C, NB, D*D]
    return jnp.swapaxes(desc, -1, -2).reshape(B, C, D * D * NB)


def finalize_descriptors(desc: jax.Array, cfg: SiftConfig) -> jax.Array:
    """normalize -> clip -> renormalize -> uint8 quantize. desc: [..., 128]."""
    if not cfg.unnormalized:
        n = jnp.linalg.norm(desc, axis=-1, keepdims=True)
        desc = desc / jnp.maximum(n, 1e-12)
        desc = jnp.minimum(desc, cfg.descriptor_clip)
        n = jnp.linalg.norm(desc, axis=-1, keepdims=True)
        desc = desc / jnp.maximum(n, 1e-12)
    return jnp.clip(jnp.floor(512.0 * desc + 0.5), 0, 255).astype(jnp.uint8)


# Keypoint slots per `lax.map` step of `compute_descriptors`: on the H100,
# batch 4 ran fastest at chunk 512 and batch 1 at chunk 2048 (PERF.md).
_SLOTS_PER_STEP = 2048


def compute_descriptors(
    grads: GradStack,
    y: jax.Array, x: jax.Array, sigma: jax.Array, theta: jax.Array,
    grad_level: jax.Array, cfg: SiftConfig, chunk: int | None = None,
) -> jax.Array:
    """All inputs [B, K2] (orientation axis pre-flattened). -> uint8 [B, K2, 128].

    Chunked over keypoints with `lax.map` to bound the [B, chunk, G, G, NB]
    intermediate (SURVEY §7.4: memory, not FLOPs, is the constraint here);
    by default each step holds about `_SLOTS_PER_STEP` slots of the batch.
    """
    B, K2 = y.shape
    chunk = chunk or min(K2, max(1, _SLOTS_PER_STEP // B))
    lvl = grad_level - 1
    pad = (-K2) % chunk
    if pad:
        zf = lambda a: jnp.pad(a, ((0, 0), (0, pad)))
        y, x, sigma, theta = map(zf, (y, x, sigma, theta))
        lvl = jnp.pad(lvl, ((0, 0), (0, pad)))
    nc = y.shape[1] // chunk

    def to_chunks(a):
        return jnp.moveaxis(a.reshape(B, nc, chunk), 1, 0)

    args = tuple(map(to_chunks, (y, x, sigma, theta, lvl)))

    def body(a):
        cy, cx, cs, cth, cl = a
        return _descriptor_chunk(grads, cy, cx, cs, cth, cl, cfg)

    out = jax.lax.map(body, args)                  # [nc, B, chunk, 128]
    out = jnp.moveaxis(out, 0, 1).reshape(B, nc * chunk, -1)[:, :K2]
    return finalize_descriptors(out, cfg)
