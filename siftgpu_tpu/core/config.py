"""Frozen configuration for the SIFT front end.

Replaces the reference's ambient global mutable state (`GlobalUtil::_*` statics +
`SiftParam`, SURVEY.md §5.6 ⚠) with one hashable frozen dataclass that is passed
explicitly and used as a `jax.jit` static argument.  All shapes derived from it
(octave sizes, window sizes, keypoint capacities) are static Python ints so the
whole pipeline traces with fixed shapes — the core design decision
(SURVEY.md §7.1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from . import scalespace

__all__ = ["SiftConfig", "MatchConfig"]


def _num_octaves(h: int, w: int, min_dim: int) -> int:
    n = 0
    while min(h, w) >= min_dim:
        n += 1
        h //= 2
        w //= 2
    return max(n, 1)


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """Static SIFT extraction parameters.

    Field name ↔ reference flag parity (SiftGPU `ParseParam` ⚠, SURVEY.md §5.6):
      dog_levels       ↔ -d     (DoG levels per octave, default 3)
      dog_threshold    ↔ -t     (contrast threshold, default 0.02/3)
      edge_threshold   ↔ -e     (Hessian edge curvature ratio, default 10)
      first_octave     ↔ -fo    (-1 = 2x upsample; n>0 = skip n fine octaves)
      max_keypoints    ↔ -tc    (feature count cap; ours is a hard static cap)
      max_orientations ↔ -m     (<=2 orientations per keypoint)
      subpixel         ↔ -s     (3x3x3 quadratic subpixel refinement)
      lowe_origin      ↔ -loweo (+0.5 pixel origin convention)
      unnormalized     ↔ -unn   (skip descriptor normalization)
      (-maxd maps to the API-level "max_dim" preprocess in SiftTPU — it
       downsamples the IMAGE before a config is derived, so it is not a
       SiftConfig field; -f maps to kernel_truncate, the filter width
       factor; max_filter_width has no reference flag and caps tap radius)
    """

    # --- image geometry (static; determines every downstream shape) ---
    height: int = 480
    width: int = 640
    batch: int = 1

    # --- scale space ---
    dog_levels: int = 3            # S
    sigma0: float = 1.6
    sigma_n: float = 0.5
    first_octave: int = 0          # -1 => upsample input 2x
    num_octaves: int = 0           # 0 => auto from image size
    min_octave_dim: int = 16
    kernel_truncate: float = 4.0   # filter radius = ceil(truncate * sigma)
    max_filter_width: int = 0      # 0 => uncapped (radius cap, pixels)

    # --- detection ---
    dog_threshold: float = 0.02 / 3.0
    edge_threshold: float = 10.0
    subpixel: bool = True
    keep_sign: bool = False        # -sign: signed response; minima get -sigma
    border: int = 5                # reject keypoints within `border` px of edge

    # --- keypoint capacities (static buffer sizes; SURVEY §7.1 fixed shapes) ---
    max_keypoints: int = 2048      # final per-image cap K
    # `-tc/-tc1/-tc2/-tc3` truncation preference when the cap binds
    # (GlobalUtil::_TruncateMethod analog ⚠ SURVEY §5.6; the mount is empty so
    # the per-method semantics are this repo's documented choice):
    #   0 (-tc/-tc3): keep the highest-response features (quality-preserving)
    #   1 (-tc1):     prefer FINE octaves (small scale), response breaks ties
    #   2 (-tc2):     prefer COARSE octaves (large scale), response breaks ties
    truncate_method: int = 0
    per_octave_cap: int = 0        # 0 => auto: max(64, max_keypoints >> octave)

    # --- orientation ---
    max_orientations: int = 2
    orientation_bins: int = 36
    orientation_sigma_factor: float = 1.5   # sigma_w = 1.5 * sigma
    orientation_radius_factor: float = 3.0  # radius = 3 * sigma_w
    orientation_peak_ratio: float = 0.8

    # --- descriptor ---
    descriptor_width: int = 4      # 4x4 spatial cells
    descriptor_bins: int = 8       # orientation bins per cell
    descriptor_spacing: float = 3.0  # cell size = 3 * sigma (pixels at octave scale)
    descriptor_samples_per_cell: int = 4  # 16x16 sample grid
    descriptor_clip: float = 0.2
    unnormalized: bool = False

    # --- conventions / numerics ---
    lowe_origin: bool = False
    pyramid_dtype: str = "float32"
    # `-obo`: octave-by-octave processing (GlobalUtil::_ProcessOBO analog ⚠
    # SURVEY §5.7): one dispatch per octave bounds peak HBM to one octave's
    # working set; identical outputs (frontend.extract.extract_features_obo)
    process_obo: bool = False

    # ---------------- derived static geometry ----------------

    @property
    def gauss_levels(self) -> int:
        return self.dog_levels + 3

    @property
    def upsampled(self) -> bool:
        return self.first_octave < 0

    @property
    def base_shape(self) -> Tuple[int, int]:
        """Shape of octave 0.

        first_octave == -1: 2x bilinear upsample of the input.
        first_octave ==  n > 0: the pyramid starts at the input decimated n
        times (reference `GlobalUtil::_octave_min_default` semantics ⚠ SURVEY
        §5.6 — skip the finest n octaves).  Each decimation keeps the top-left
        pixel of every 2x2 block, so a dimension halves as ceil(n/2) — the
        same convention as the intra-pyramid downsample."""
        if self.upsampled:
            return (self.height * 2, self.width * 2)
        h, w = self.height, self.width
        for _ in range(self.first_octave):
            h, w = max((h + 1) // 2, 1), max((w + 1) // 2, 1)
        return (h, w)

    @property
    def octaves(self) -> int:
        if self.num_octaves > 0:
            return self.num_octaves
        h, w = self.base_shape
        return _num_octaves(h, w, self.min_octave_dim)

    def octave_shape(self, o: int) -> Tuple[int, int]:
        h, w = self.base_shape
        return (max(h >> o, 1), max(w >> o, 1))

    def octave_scale(self, o: int) -> float:
        """Multiply octave-local coordinates by this to get input-image coords."""
        return float(2 ** (o + self.first_octave))

    def octave_cap(self, o: int) -> int:
        """Static keypoint capacity for octave `o` (pre-orientation-split)."""
        if self.per_octave_cap > 0:
            cap = self.per_octave_cap
        else:
            cap = max(64, self.max_keypoints >> o)
        # never more candidates than pixels in the detect volume
        h, w = self.octave_shape(o)
        return int(min(cap, self.dog_levels * h * w))

    @property
    def total_candidate_cap(self) -> int:
        """Sum of per-octave caps times orientation multiplicity."""
        return sum(self.octave_cap(o) for o in range(self.octaves)) * self.max_orientations

    @property
    def max_detect_sigma(self) -> float:
        return scalespace.max_detect_sigma(self.dog_levels, self.sigma0)

    @property
    def orient_window_radius(self) -> int:
        """Static radius of the orientation gather window (covers max sigma)."""
        r = self.orientation_radius_factor * self.orientation_sigma_factor
        return int(math.ceil(r * self.max_detect_sigma))

    @property
    def descriptor_grid(self) -> int:
        """Samples per side of the rotated descriptor sampling grid (e.g. 16)."""
        return self.descriptor_width * self.descriptor_samples_per_cell

    @property
    def descriptor_dim(self) -> int:
        return self.descriptor_width * self.descriptor_width * self.descriptor_bins

    # ---------------- schedules (NumPy, shared with oracle) ----------------

    def level_sigmas(self):
        return scalespace.level_sigmas(self.dog_levels, self.sigma0)

    def incremental_sigmas(self):
        return scalespace.incremental_sigmas(self.dog_levels, self.sigma0)

    def initial_blur_sigma(self) -> float:
        return scalespace.initial_blur_sigma(self.sigma0, self.sigma_n, self.upsampled)

    def gaussian_taps(self, sigma: float):
        return scalespace.gaussian_taps(sigma, self.kernel_truncate, self.max_filter_width)

    # ---------------- construction helpers ----------------

    @classmethod
    def for_image(cls, height: int, width: int, **kw) -> "SiftConfig":
        return cls(height=height, width=width, **kw)

    def replace(self, **kw) -> "SiftConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Static matcher parameters (SiftMatchGPU analog ⚠, SURVEY.md §2.1).

    `GetSiftMatch(max_match, distmax=0.7, ratiomax=0.8, mutual_best=1)` parity:
    distances are angular (arccos of the dot product of L2-normalized
    descriptors), thresholds in radians.
    """

    max_sift: int = 4096           # SetMaxSift analog: descriptor capacity
    max_match: int = 4096          # output match-buffer capacity
    dist_max: float = 0.7          # max angular distance (radians)
    ratio_max: float = 0.8         # best/second-best angle ratio
    mutual_best: bool = True
    # > 0: stream d1 in column blocks of this size (never materializing the
    # [N0, N1] similarity matrix) when N1 exceeds it — for descriptor sets
    # far beyond SetMaxSift's ~8k.  0 = AUTO: the streaming path engages
    # with `stream_block` columns whenever N1 > `stream_threshold`; below it
    # the dense path is untouched.  -1 = always dense.  The threshold and
    # block are carried over untuned; PERF.md has the 16k x 16k time they
    # give on the H100.
    block_size: int = 0
    stream_threshold: int = 4096
    stream_block: int = 1024

    def replace(self, **kw) -> "MatchConfig":
        return dataclasses.replace(self, **kw)
