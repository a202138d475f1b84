"""Golden CPU oracle: naive NumPy SIFT, obviously correct, deliberately slow.

This is the in-repo parity reference (SURVEY.md §4 item 1): the reference mount
is empty, so algorithmic ground truth is defined HERE and the JAX path is tested
against it.  The algorithm follows the canonical SiftGPU/Lowe pipeline
(SURVEY.md §2.1, §3.1 ⚠):

  Gaussian pyramid -> DoG -> 26-neighbor extrema -> contrast + Hessian edge
  tests -> 3x3x3 quadratic subpixel refinement -> 36-bin orientation histogram
  (<=2 peaks >= 80% of max, parabolic refinement) -> 128-D descriptor from a
  rotated 16x16 bilinear sample grid with trilinear (4x4 spatial x 8
  orientation) binning -> normalize, clip 0.2, renormalize, uint8 quantize.

Conventions pinned here (the JAX path must match bit-for-bit up to float
associativity):
  - replicate ("edge") padding for all convolutions (GL clamp-to-edge analog);
  - octave o+1 seeded by 2x decimation (top-left pixel) of gaussian level S;
  - pre-threshold 0.8*t before refinement, final |D_refined| >= t;
  - gradient = central difference on the Gaussian level nearest the refined
    scale, clamped to detected slices [1, S];
  - orientation histogram smoothed 6x with a circular [1,1,1]/3 box filter;
  - descriptor samples: G x G grid (G = 16), spacing 3*sigma/4, rotated by
    theta, gradient bilinearly interpolated as (gx, gy) then converted to
    magnitude/angle; Gaussian spatial weight exp(-r_cell^2 / (2*(width/2)^2));
  - descriptor flattening order: index = (row_cell*4 + col_cell)*8 + ori_bin;
  - uint8 quantization: clamp(floor(512*v + 0.5), 0, 255).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from ..core.config import SiftConfig

__all__ = [
    "convolve_sep",
    "build_pyramid",
    "detect_keypoints",
    "compute_orientations",
    "compute_descriptor",
    "extract",
]


# ---------------------------------------------------------------------------
# pyramid
# ---------------------------------------------------------------------------

def convolve_sep(img: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Separable 2-D convolution with replicate padding (float32)."""
    r = (len(taps) - 1) // 2
    out = np.zeros_like(img, dtype=np.float64)
    pad = np.pad(img.astype(np.float64), ((0, 0), (r, r)), mode="edge")
    for i, t in enumerate(taps):
        out += t * pad[:, i : i + img.shape[1]]
    img2 = out
    out = np.zeros_like(img2)
    pad = np.pad(img2, ((r, r), (0, 0)), mode="edge")
    for i, t in enumerate(taps):
        out += t * pad[i : i + img.shape[0], :]
    return out.astype(np.float32)


def upsample2x(img: np.ndarray) -> np.ndarray:
    """Bilinear 2x upsample, align_corners=False style (matches jax.image.resize
    'linear'): output pixel centers at (i+0.5)/2 - 0.5 in input coords."""
    h, w = img.shape
    yy = (np.arange(2 * h) + 0.5) / 2.0 - 0.5
    xx = (np.arange(2 * w) + 0.5) / 2.0 - 0.5
    y0 = np.clip(np.floor(yy).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xx).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(yy - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xx - x0, 0.0, 1.0)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return ((a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy).astype(
        np.float32
    )


def build_pyramid(img: np.ndarray, cfg: SiftConfig) -> List[Dict[str, np.ndarray]]:
    """Returns per-octave dicts with 'gauss' [S+3,H,W] and 'dog' [S+2,H,W]."""
    assert img.ndim == 2, "oracle operates on a single grayscale image"
    img = img.astype(np.float32)
    if cfg.upsampled:
        img = upsample2x(img)
    else:
        for _ in range(cfg.first_octave):  # -fo n > 0: top-left decimation
            img = img[::2, ::2]
    base = convolve_sep(img, cfg.gaussian_taps(cfg.initial_blur_sigma()))
    inc = cfg.incremental_sigmas()
    octaves = []
    for o in range(cfg.octaves):
        levels = [base]
        for s in inc:
            levels.append(convolve_sep(levels[-1], cfg.gaussian_taps(float(s))))
        gauss = np.stack(levels)  # [S+3, H, W]
        dog = gauss[1:] - gauss[:-1]  # [S+2, H, W]
        octaves.append({"gauss": gauss, "dog": dog})
        # seed next octave: decimate level S (sigma = 2*sigma0)
        base = gauss[cfg.dog_levels][::2, ::2]
    return octaves


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

def _subpixel_refine(dog: np.ndarray, l: int, y: int, x: int):
    """3x3x3 quadratic fit. Returns (offset[3] as (dl,dy,dx), refined_value)."""
    D = dog
    v = D[l, y, x]
    g = np.array(
        [
            0.5 * (D[l + 1, y, x] - D[l - 1, y, x]),
            0.5 * (D[l, y + 1, x] - D[l, y - 1, x]),
            0.5 * (D[l, y, x + 1] - D[l, y, x - 1]),
        ]
    )
    dll = D[l + 1, y, x] + D[l - 1, y, x] - 2 * v
    dyy = D[l, y + 1, x] + D[l, y - 1, x] - 2 * v
    dxx = D[l, y, x + 1] + D[l, y, x - 1] - 2 * v
    dly = 0.25 * (D[l + 1, y + 1, x] - D[l + 1, y - 1, x] - D[l - 1, y + 1, x] + D[l - 1, y - 1, x])
    dlx = 0.25 * (D[l + 1, y, x + 1] - D[l + 1, y, x - 1] - D[l - 1, y, x + 1] + D[l - 1, y, x - 1])
    dyx = 0.25 * (D[l, y + 1, x + 1] - D[l, y + 1, x - 1] - D[l, y - 1, x + 1] + D[l, y - 1, x - 1])
    H = np.array([[dll, dly, dlx], [dly, dyy, dyx], [dlx, dyx, dxx]])
    det = np.linalg.det(H)
    if abs(det) < 1e-12:
        off = np.zeros(3)
    else:
        off = -np.linalg.solve(H, g)
    val = v + 0.5 * float(g @ off)
    return off, val


def detect_keypoints(pyr, cfg: SiftConfig):
    """Returns list of dict(octave, level, y, x, sigma, response, grad_level)
    with y/x/level refined (octave-local float coords)."""
    kps = []
    pre_t = 0.8 * cfg.dog_threshold
    r = cfg.edge_threshold
    edge_t = (r + 1.0) ** 2 / r
    for o, oc in enumerate(pyr):
        dog = oc["dog"]
        S2, H, W = dog.shape
        for l in range(1, cfg.dog_levels + 1):
            for y in range(1, H - 1):
                for x in range(1, W - 1):
                    v = dog[l, y, x]
                    if abs(v) <= pre_t:
                        continue
                    patch = dog[l - 1 : l + 2, y - 1 : y + 2, x - 1 : x + 2]
                    if v > 0:
                        if v < patch.max() or (patch == v).sum() > 1:
                            continue
                    else:
                        if v > patch.min() or (patch == v).sum() > 1:
                            continue
                    # Hessian edge test on the DoG slice
                    dxx = dog[l, y, x + 1] + dog[l, y, x - 1] - 2 * v
                    dyy = dog[l, y + 1, x] + dog[l, y - 1, x] - 2 * v
                    dxy = 0.25 * (
                        dog[l, y + 1, x + 1]
                        - dog[l, y + 1, x - 1]
                        - dog[l, y - 1, x + 1]
                        + dog[l, y - 1, x - 1]
                    )
                    tr = dxx + dyy
                    det = dxx * dyy - dxy * dxy
                    if det <= 0 or tr * tr / det >= edge_t:
                        continue
                    if cfg.subpixel:
                        off, val = _subpixel_refine(dog, l, y, x)
                        if np.max(np.abs(off)) > 1.5:
                            continue
                        # clamp the LEVEL offset to +-0.5: beyond that the
                        # extremum belongs to the adjacent slice, and the
                        # static JAX windows are sized for sigma up to
                        # sigma0 * 2^((S+0.5)/S) (scalespace.max_detect_sigma)
                        off[0] = np.clip(off[0], -0.5, 0.5)
                    else:
                        off, val = np.zeros(3), v
                    if abs(val) < cfg.dog_threshold:
                        continue
                    fy, fx = y + off[1], x + off[2]
                    fl = l + off[0]
                    if not (cfg.border <= fy < H - cfg.border and cfg.border <= fx < W - cfg.border):
                        continue
                    sigma = cfg.sigma0 * 2.0 ** (fl / cfg.dog_levels)
                    grad_level = int(np.clip(round(fl), 1, cfg.dog_levels))
                    kps.append(
                        dict(
                            octave=o,
                            level=fl,
                            grad_level=grad_level,
                            y=fy,
                            x=fx,
                            sigma=sigma,
                            response=abs(val),
                        )
                    )
    return kps


# ---------------------------------------------------------------------------
# gradients / orientation
# ---------------------------------------------------------------------------

def gradients(gauss_level: np.ndarray):
    """Central-difference gradients with edge clamping. Returns (gx, gy)."""
    g = gauss_level.astype(np.float32)
    gx = 0.5 * (np.roll(g, -1, axis=1) - np.roll(g, 1, axis=1))
    gx[:, 0] = g[:, 1] - g[:, 0]
    gx[:, -1] = g[:, -1] - g[:, -2]
    gy = 0.5 * (np.roll(g, -1, axis=0) - np.roll(g, 1, axis=0))
    gy[0, :] = g[1, :] - g[0, :]
    gy[-1, :] = g[-1, :] - g[-2, :]
    return gx, gy


def _smooth_hist(h: np.ndarray, iters: int = 6) -> np.ndarray:
    for _ in range(iters):
        h = (np.roll(h, 1) + h + np.roll(h, -1)) / 3.0
    return h


def compute_orientations(gx, gy, kp, cfg: SiftConfig) -> List[float]:
    """36-bin weighted histogram; returns up to max_orientations angles [0,2pi)."""
    H, W = gx.shape
    nb = cfg.orientation_bins
    sw = cfg.orientation_sigma_factor * kp["sigma"]
    radius = cfg.orientation_radius_factor * sw
    R = int(math.ceil(radius))
    cy, cx = kp["y"], kp["x"]
    iy, ix = int(round(cy)), int(round(cx))
    hist = np.zeros(nb)
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            y, x = iy + dy, ix + dx
            if not (0 <= y < H and 0 <= x < W):
                continue
            oy, ox = y - cy, x - cx
            r2 = ox * ox + oy * oy
            if r2 > radius * radius:
                continue
            m = math.hypot(gx[y, x], gy[y, x])
            ang = math.atan2(gy[y, x], gx[y, x]) % (2 * math.pi)
            w = math.exp(-r2 / (2 * sw * sw))
            b = int(ang / (2 * math.pi) * nb) % nb
            hist[b] += w * m
    hist = _smooth_hist(hist)
    mx = hist.max()
    if mx <= 0:
        return [0.0]
    peaks = []
    for i in range(nb):
        l, r_ = hist[(i - 1) % nb], hist[(i + 1) % nb]
        if hist[i] > l and hist[i] > r_ and hist[i] >= cfg.orientation_peak_ratio * mx:
            denom = l - 2 * hist[i] + r_
            d = 0.0 if abs(denom) < 1e-12 else 0.5 * (l - r_) / denom
            ang = (2 * math.pi) * ((i + 0.5 + d) / nb) % (2 * math.pi)
            peaks.append((hist[i], ang))
    peaks.sort(key=lambda p: -p[0])
    return [a for _, a in peaks[: cfg.max_orientations]] or [0.0]


# ---------------------------------------------------------------------------
# descriptor
# ---------------------------------------------------------------------------

def _bilinear(img: np.ndarray, y: float, x: float) -> float:
    H, W = img.shape
    if y < 0 or x < 0 or y > H - 1 or x > W - 1:
        return 0.0
    y0, x0 = int(math.floor(y)), int(math.floor(x))
    y1, x1 = min(y0 + 1, H - 1), min(x0 + 1, W - 1)
    fy, fx = y - y0, x - x0
    return (
        img[y0, x0] * (1 - fy) * (1 - fx)
        + img[y0, x1] * (1 - fy) * fx
        + img[y1, x0] * fy * (1 - fx)
        + img[y1, x1] * fy * fx
    )


def compute_descriptor(gx, gy, kp, theta: float, cfg: SiftConfig) -> np.ndarray:
    """128-D float descriptor (pre-quantization) from rotated G x G samples."""
    G = cfg.descriptor_grid              # 16
    D = cfg.descriptor_width             # 4
    NB = cfg.descriptor_bins             # 8
    spc = cfg.descriptor_spacing * kp["sigma"] / cfg.descriptor_samples_per_cell
    ct, st = math.cos(theta), math.sin(theta)
    cy, cx = kp["y"], kp["x"]
    hist = np.zeros((D, D, NB))
    half = (G - 1) / 2.0
    sigma_w = D / 2.0                    # in cell units
    for i in range(G):                   # rows (v -> y)
        for j in range(G):               # cols (u -> x)
            u = (j - half) * spc
            v = (i - half) * spc
            px = cx + ct * u - st * v
            py = cy + st * u + ct * v
            sgx = _bilinear(gx, py, px)
            sgy = _bilinear(gy, py, px)
            m = math.hypot(sgx, sgy)
            if m == 0.0:
                continue
            ang = (math.atan2(sgy, sgx) - theta) % (2 * math.pi)
            # cell-unit coordinates of the (unrotated) sample
            ccol = (j - half) / cfg.descriptor_samples_per_cell + (D - 1) / 2.0
            crow = (i - half) / cfg.descriptor_samples_per_cell + (D - 1) / 2.0
            gw = math.exp(
                -(((ccol - (D - 1) / 2.0) ** 2 + (crow - (D - 1) / 2.0) ** 2))
                / (2.0 * sigma_w * sigma_w)
            )
            ob = ang / (2 * math.pi) * NB
            o0 = int(math.floor(ob)) % NB
            fo = ob - math.floor(ob)
            r0 = int(math.floor(crow))
            c0 = int(math.floor(ccol))
            fr = crow - r0
            fc = ccol - c0
            contrib = m * gw
            for dr, wr in ((r0, 1 - fr), (r0 + 1, fr)):
                if not (0 <= dr < D):
                    continue
                for dc, wc in ((c0, 1 - fc), (c0 + 1, fc)):
                    if not (0 <= dc < D):
                        continue
                    hist[dr, dc, o0] += contrib * wr * wc * (1 - fo)
                    hist[dr, dc, (o0 + 1) % NB] += contrib * wr * wc * fo
    return hist.reshape(-1)


def finalize_descriptor(desc: np.ndarray, cfg: SiftConfig) -> np.ndarray:
    """normalize -> clip 0.2 -> renormalize -> uint8 (SURVEY §2.4 item 6)."""
    if cfg.unnormalized:
        q = desc
    else:
        n = np.linalg.norm(desc)
        d = desc / max(n, 1e-12)
        d = np.minimum(d, cfg.descriptor_clip)
        n = np.linalg.norm(d)
        q = d / max(n, 1e-12)
    return np.clip(np.floor(512.0 * q + 0.5), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# full extraction
# ---------------------------------------------------------------------------

def extract(img: np.ndarray, cfg: SiftConfig) -> Dict[str, np.ndarray]:
    """Full oracle pipeline on one grayscale image in [0, 1].

    Returns dict of arrays sorted by response (desc): x, y (input-image coords),
    sigma, theta, response, octave, desc (uint8 [N,128]).
    """
    pyr = build_pyramid(img, cfg)
    kps = detect_keypoints(pyr, cfg)
    grads = {}
    rows = []
    for kp in kps:
        key = (kp["octave"], kp["grad_level"])
        if key not in grads:
            grads[key] = gradients(pyr[kp["octave"]]["gauss"][kp["grad_level"]])
        gx, gy = grads[key]
        for theta in compute_orientations(gx, gy, kp, cfg):
            desc = compute_descriptor(gx, gy, kp, theta, cfg)
            desc = finalize_descriptor(desc, cfg)
            scale = cfg.octave_scale(kp["octave"])
            shift = 0.5 if cfg.lowe_origin else 0.0
            rows.append(
                (
                    (kp["x"] + shift) * scale,
                    (kp["y"] + shift) * scale,
                    kp["sigma"] * scale,
                    theta,
                    kp["response"],
                    kp["octave"],
                    desc,
                )
            )
    rows.sort(key=lambda r: -r[4])
    rows = rows[: cfg.max_keypoints]
    if not rows:
        return dict(
            x=np.zeros(0), y=np.zeros(0), sigma=np.zeros(0), theta=np.zeros(0),
            response=np.zeros(0), octave=np.zeros(0, int),
            desc=np.zeros((0, cfg.descriptor_dim), np.uint8),
        )
    x, y, s, t, r, o, d = zip(*rows)
    return dict(
        x=np.array(x), y=np.array(y), sigma=np.array(s), theta=np.array(t),
        response=np.array(r), octave=np.array(o, int), desc=np.stack(d),
    )
