"""bmfr_tpu — a JAX rebuild of BMFR (Blockwise Multi-Order Feature
Regression) real-time path-tracing denoising.

Reference behavior: tcantenot/bmfr (OpenCL), re-designed in JAX/Pallas: the
five-kernel OpenCL chain (opencl/bmfr.cl) becomes pure functions over
channels-first image planes, the per-workgroup block fit becomes batched
linear algebra (or one fused GPU program per block), and the frame
recurrence becomes a ``jax.lax.scan``.
"""

from .config import BMFRConfig, DEFAULT_CONFIG
from .pipeline import TemporalState, denoise_frame, denoise_sequence, make_denoise_frame
from .pipeline.denoise import FrameInputs

__all__ = [
    "BMFRConfig",
    "DEFAULT_CONFIG",
    "TemporalState",
    "FrameInputs",
    "denoise_frame",
    "denoise_sequence",
    "make_denoise_frame",
]

__version__ = "0.1.0"
