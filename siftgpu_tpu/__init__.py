"""siftgpu_tpu: a JAX SLAM/SfM engine with a SiftGPU-class front end.

Brand-new JAX/XLA implementation (not a port) of the capabilities of the
SiftGPU-derived reference (SURVEY.md): Gaussian/DoG pyramid, subpixel extrema,
orientation assignment, 128-D descriptors, brute-force + guided matching, and
an SfM back end (RANSAC two-view geometry, bundle adjustment, pose graph)
designed for SPMD execution over device meshes.
"""

from .core.config import MatchConfig, SiftConfig
from .frontend.extract import Features, extract_features, extract_features_jit

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: the class façades pull in the full pipeline stack
    if name in ("SiftTPU", "SiftMatchTPU"):
        from .pipeline import api

        return getattr(api, name)
    raise AttributeError(name)


__all__ = [
    "SiftConfig",
    "MatchConfig",
    "Features",
    "extract_features",
    "extract_features_jit",
    "SiftTPU",
    "SiftMatchTPU",
]
