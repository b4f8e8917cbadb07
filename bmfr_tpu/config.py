"""Configuration for the BMFR denoising pipeline.

The reference (tcantenot/bmfr) configures everything through compile-time
preprocessor macros serialized into OpenCL ``-D`` build options
(``opencl/bmfr.cpp:32-118`` and ``:204-243``); the feature list is literal
OpenCL source text pasted into the kernels (``opencl/bmfr.cpp:65-77``).

Here the whole configuration surface is a single frozen (hashable) dataclass
that can be passed as a static argument to ``jax.jit``: image geometry,
algorithm parameters, per-scene reprojection thresholds (which the reference
reads from the dataset's generated ``camera_matrices.h``,
``opencl/bmfr.cpp:226-227``), precision flags and solver/backend selection.
Feature lists are data (names resolved via :mod:`bmfr_tpu.features`), not code.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


#: block edges the fused fitter is built for: one power-of-two tile per GPU
#: program (ops/fitter_fused.py)
FUSED_BLOCK_EDGES = (8, 16, 32)

# Default feature sets, mirroring opencl/bmfr.cpp:65-77:
#   NOT_SCALED_FEATURE_BUFFERS = "1.f, normal.x, normal.y, normal.z,"
#   SCALED_FEATURE_BUFFERS     = "world_position.{x,y,z}, world_position.{x,y,z}**2"
DEFAULT_FEATURES_NOT_SCALED = ("const", "normal_x", "normal_y", "normal_z")
DEFAULT_FEATURES_SCALED = (
    "world_position_x",
    "world_position_y",
    "world_position_z",
    "world_position_x2",
    "world_position_y2",
    "world_position_z2",
)


@dataclass(frozen=True)
class BMFRConfig:
    """All knobs of the pipeline. Frozen => usable as a jit static arg.

    Parameter defaults follow the reference macros (opencl/bmfr.cpp:56-98).
    """

    # --- input description (opencl/bmfr.cpp:39-42) ---
    image_width: int = 1280
    image_height: int = 720

    # --- algorithm parameters (opencl/bmfr.cpp:56-77) ---
    #: Amplitude of the deterministic hash-noise added to the feature columns
    #: before the QR factorization to cancel singularities (NOISE_AMOUNT,
    #: opencl/bmfr.cpp:58, used at opencl/bmfr.cl:173-182).
    noise_amount: float = 1e-2
    #: Cap for the first (pre-fit, noisy) temporal accumulation blend factor
    #: (BLEND_ALPHA, opencl/bmfr.cpp:60, used at opencl/bmfr.cl:425-429).
    blend_alpha: float = 0.2
    #: Cap for the second (post-fit, filtered) accumulation blend factor
    #: (SECOND_BLEND_ALPHA, opencl/bmfr.cpp:61, used at opencl/bmfr.cl:836-839).
    second_blend_alpha: float = 0.1
    #: New-frame weight in the final TAA blend (TAA_BLEND_ALPHA,
    #: opencl/bmfr.cpp:62, used at opencl/bmfr.cl:971-972).
    taa_blend_alpha: float = 0.2
    #: Feature names resolved through bmfr_tpu.features.FEATURE_REGISTRY.
    #: Not-scaled features are assumed to already be in [-1, 1].
    features_not_scaled: tuple = DEFAULT_FEATURES_NOT_SCALED
    #: Features min-max rescaled per 32x32 block before fitting
    #: (opencl/bmfr.cl:511-542).
    features_scaled: tuple = DEFAULT_FEATURES_SCALED

    # --- per-scene reprojection discard thresholds ---
    # The reference injects these from the dataset's camera_matrices.h
    # (opencl/bmfr.cpp:226-227). They gate the bilinear reprojection taps
    # (opencl/bmfr.cl:393, :404). Scene-specific; these defaults match the
    # published TUNI BMFR dataset headers' order of magnitude.
    position_limit_squared: float = 0.01
    normal_limit_squared: float = 1.0

    # --- block geometry (opencl/bmfr.cpp:102-118) ---
    #: Edge length of a fitting block. The reference supports only 32
    #: (opencl/bmfr.cpp:103-104); we support any multiple of 8 >= 8 for the
    #: block-size sweeps (BASELINE config 4).
    block_edge: int = 32

    # --- precision / tuning ---
    #: Storage dtype of the blocked feature matrix between build and fit.
    #: The reference stores tmp_data in fp16 (USE_HALF_PRECISION_IN_TMP_DATA,
    #: opencl/bmfr.cpp:88, opencl/bmfr.cl:255-265) with +-65504 clamping.
    #: "float32" (default here) skips the rounding; "float16"/"bfloat16"
    #: replicate reduced-precision storage as a config axis.
    tmp_data_dtype: str = "float32"
    #: Least-squares solver for the per-block fit:
    #: "householder" replicates the reference's Householder QR + back
    #: substitution (opencl/bmfr.cl:549-699); "cholesky" solves the normal
    #: equations (Gram matrix + Cholesky) — mathematically the same LS
    #: solution, fewer operations, at some conditioning risk.
    solver: str = "householder"
    #: Fitter backend: "xla" (blocked feature tensor + batched linear
    #: algebra, ops/fitter.py) or "fused" (one GPU program per block that
    #: fits and reconstructs on chip, ops/fitter_fused.py; block_edge must
    #: be 8, 16 or 32).
    fitter_impl: str = "xla"
    #: Run Pallas kernels in the Pallas interpreter instead of compiling
    #: them for the GPU (CPU tests only).
    pallas_interpret: bool = False
    #: Gather strategy for the temporal reprojection taps (K1/K4/K5):
    #: "float32" = exact, one gather per tap;
    #: "packed_bf16" = two bf16 channels per 32-bit word;
    #: "packed_x_bf16" = each gather fetches a horizontal bf16 tap pair
    #: (~0.4% relative rounding on gathered history).
    warp_mode: str = "float32"
    #: Arithmetic dtype of the TAA 3x3 YCoCg neighborhood AABB scan (K5).
    #: "bfloat16" halves its bytes, mirroring the reference's own
    #: half-precision pragmatism (opencl/bmfr.cl:255-265); clamp bounds
    #: are perturbed <= 1 bf16 ulp and outputs stay f32. K4's blend math
    #: stays f32 always: it updates recurrent state.
    residual_dtype: str = "float32"

    # --- stage-bypass debug flags ---
    # The reference documents debugging by bisecting the 5-stage chain with
    # commented-out bypasses (opencl/bmfr.cl:752-754, :782-784, :881-883).
    # Here the bypasses are first-class config.
    skip_fitting: bool = False        # weighted_sum passes noisy through
    skip_second_accum: bool = False   # K4 uses filtered color directly
    skip_taa: bool = False            # K5 passes its input through

    # ------------------------------------------------------------------
    # Derived geometry (opencl/bmfr.cpp:102-118)
    # ------------------------------------------------------------------
    @property
    def block_pixels(self) -> int:
        return self.block_edge * self.block_edge

    @property
    def workset_width(self) -> int:
        b = self.block_edge
        return b * ((self.image_width + b - 1) // b)

    @property
    def workset_height(self) -> int:
        b = self.block_edge
        return b * ((self.image_height + b - 1) // b)

    @property
    def workset_with_margins_width(self) -> int:
        return self.workset_width + self.block_edge

    @property
    def workset_with_margins_height(self) -> int:
        return self.workset_height + self.block_edge

    @property
    def blocks_x(self) -> int:
        """Horizontal block count of the margins grid (41 at defaults)."""
        return self.workset_with_margins_width // self.block_edge

    @property
    def blocks_y(self) -> int:
        """Vertical block count of the margins grid (24 at defaults)."""
        return self.workset_with_margins_height // self.block_edge

    @property
    def n_blocks(self) -> int:
        """Total fitted blocks per frame (FITTER_GLOBAL/LOCAL_SIZE, 984)."""
        return self.blocks_x * self.blocks_y

    # ------------------------------------------------------------------
    # Derived feature counts (opencl/bmfr.cpp:193-202)
    # ------------------------------------------------------------------
    @property
    def features_not_scaled_count(self) -> int:
        return len(self.features_not_scaled)

    @property
    def features_scaled_count(self) -> int:
        return len(self.features_scaled)

    @property
    def feature_count(self) -> int:
        """Number of regression features (10 by default)."""
        return self.features_not_scaled_count + self.features_scaled_count

    @property
    def buffer_count(self) -> int:
        """Features + 3 noisy color channels (13 by default)."""
        return self.feature_count + 3

    @property
    def all_features(self) -> tuple:
        return tuple(self.features_not_scaled) + tuple(self.features_scaled)

    def validate(self) -> "BMFRConfig":
        if self.block_edge < 8 or self.block_edge % 8 != 0:
            raise ValueError("block_edge must be a multiple of 8 and >= 8")
        if self.feature_count < 1:
            raise ValueError("need at least one feature")
        if self.tmp_data_dtype not in ("float32", "float16", "bfloat16"):
            raise ValueError(f"bad tmp_data_dtype: {self.tmp_data_dtype}")
        if self.solver not in ("householder", "cholesky"):
            raise ValueError(f"bad solver: {self.solver}")
        if self.fitter_impl not in ("xla", "fused"):
            raise ValueError(f"bad fitter_impl: {self.fitter_impl}")
        if (self.fitter_impl == "fused"
                and self.block_edge not in FUSED_BLOCK_EDGES):
            raise ValueError(
                "fitter_impl='fused' requires block_edge 8, 16 or 32")
        if self.warp_mode not in ("float32", "packed_bf16",
                                  "packed_x_bf16"):
            raise ValueError(f"bad warp_mode: {self.warp_mode}")
        if self.residual_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"bad residual_dtype: {self.residual_dtype}")
        if self.features_not_scaled[:1] != ("const",):
            # The QR noise is never applied to column 0, which the reference
            # assumes to be the constant feature (opencl/bmfr.cl:606,625-627).
            raise ValueError("first not-scaled feature must be 'const'")
        return self

    def replace(self, **kw) -> "BMFRConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = BMFRConfig()


def bench_config(width=1280, height=720, **overrides) -> BMFRConfig:
    """The benchmarked configuration (``bench.py``, ``chip_smoke.py``):
    the synthetic scenes' reprojection limits, exact float32 taps, the
    fused per-block fitter with the Cholesky solver, and the bf16 TAA
    neighborhood scan. (On an H100 the fused fitter beat the XLA fitter
    for both solvers, and bf16 taps were no faster than float32 ones —
    PERF.md.) ``overrides`` replace any field."""
    kw = dict(image_width=width, image_height=height,
              position_limit_squared=0.03, normal_limit_squared=0.5,
              warp_mode="float32", fitter_impl="fused",
              solver="cholesky", residual_dtype="bfloat16")
    kw.update(overrides)
    return BMFRConfig(**kw).validate()
