"""Configuration of the PyTorch/CUDA port.

The same frozen dataclass as :class:`bmfr_tpu.config.BMFRConfig` — same
field names, same defaults, same derived geometry — so a JAX
configuration carries over field by field (:func:`config_from_jax`).

The port runs one configuration so far: the JAX package's flagship
(``warp_mode="pallas"``, ``fitter_impl="pallas_direct"``,
``solver="cholesky"``, f32 tmp storage, the default feature basis).
:func:`check_supported` raises ``NotImplementedError`` for anything else,
naming the ROADMAP item that will port it. ``residual_dtype`` (f32/bf16)
and the three ``skip_*`` stage bypasses are the tolerated variants.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

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
    """All knobs of the pipeline; see :mod:`bmfr_tpu.config` for the
    meaning of each field (defaults follow opencl/bmfr.cpp:56-98)."""

    image_width: int = 1280
    image_height: int = 720

    noise_amount: float = 1e-2
    blend_alpha: float = 0.2
    second_blend_alpha: float = 0.1
    taa_blend_alpha: float = 0.2
    features_not_scaled: tuple = DEFAULT_FEATURES_NOT_SCALED
    features_scaled: tuple = DEFAULT_FEATURES_SCALED

    position_limit_squared: float = 0.01
    normal_limit_squared: float = 1.0

    block_edge: int = 32

    tmp_data_dtype: str = "float32"
    solver: str = "householder"
    fitter_impl: str = "auto"
    warp_mode: str = "float32"
    residual_dtype: str = "float32"
    warp_tier_impl: str = "steady_cond"

    skip_fitting: bool = False
    skip_second_accum: bool = False
    skip_taa: bool = False

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
        return self.blocks_x * self.blocks_y

    @property
    def features_not_scaled_count(self) -> int:
        return len(self.features_not_scaled)

    @property
    def features_scaled_count(self) -> int:
        return len(self.features_scaled)

    @property
    def feature_count(self) -> int:
        return self.features_not_scaled_count + self.features_scaled_count

    @property
    def buffer_count(self) -> int:
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
        if self.fitter_impl not in ("auto", "xla", "pallas",
                                    "pallas_direct"):
            raise ValueError(f"bad fitter_impl: {self.fitter_impl}")
        if self.fitter_impl == "pallas_direct" and self.block_edge != 32:
            raise ValueError(
                "fitter_impl='pallas_direct' requires block_edge=32")
        if self.warp_mode not in ("float32", "packed_bf16",
                                  "packed_x_bf16", "pallas"):
            raise ValueError(f"bad warp_mode: {self.warp_mode}")
        if self.residual_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"bad residual_dtype: {self.residual_dtype}")
        if self.warp_tier_impl not in ("switch", "steady_cond",
                                       "steady_only"):
            raise ValueError(f"bad warp_tier_impl: {self.warp_tier_impl}")
        if self.features_not_scaled[:1] != ("const",):
            raise ValueError("first not-scaled feature must be 'const'")
        return self

    def replace(self, **kw) -> "BMFRConfig":
        return dataclasses.replace(self, **kw)


#: What the port runs: the JAX package's flagship (bench.py's config).
FLAGSHIP = dict(warp_mode="pallas", fitter_impl="pallas_direct",
                solver="cholesky", residual_dtype="bfloat16")

# field -> (value the port runs, ROADMAP item that ports the others)
_SLICE = {
    "warp_mode": ("pallas", "Queue 1 #9 (gather_taps modes)"),
    "fitter_impl": ("pallas_direct",
                    "Queue 1 #9 and Queue 2 #4 (blockified fit_blocks)"),
    "solver": ("cholesky", "Queue 2 #3 (Householder _qr_kernel)"),
    "tmp_data_dtype": ("float32",
                       "Queue 1 #9 (reduced-precision tmp storage)"),
    "block_edge": (32, "Queue 1 #9 (block-size sweeps)"),
    "features_not_scaled": (DEFAULT_FEATURES_NOT_SCALED,
                            "Queue 1 #9 (custom feature bases)"),
    "features_scaled": (DEFAULT_FEATURES_SCALED,
                        "Queue 1 #9 (custom feature bases)"),
}


def check_supported(cfg: BMFRConfig) -> BMFRConfig:
    """Validate ``cfg`` and raise ``NotImplementedError`` unless it is the
    configuration the port runs (up to the tolerated variants)."""
    cfg.validate()
    for field, (want, item) in _SLICE.items():
        got = getattr(cfg, field)
        if got != want:
            raise NotImplementedError(
                f"{field}={got!r} is not ported yet (the port runs "
                f"{field}={want!r}); ROADMAP {item}")
    if cfg.warp_tier_impl == "steady_only":
        # the GPU warp has no tiers: "switch" and "steady_cond" are
        # value-identical on the TPU and both equal the exact tier here
        raise NotImplementedError(
            "warp_tier_impl='steady_only' is a TPU measurement knob with "
            "no GPU counterpart")
    return cfg


def config_from_jax(cfg) -> BMFRConfig:
    """The port's config with every field of a JAX ``BMFRConfig``."""
    return BMFRConfig(**dataclasses.asdict(cfg))
