"""Typed configuration, a copy of ``unetseg_tpu.config``.

The port keeps its own copy so that it never imports the JAX package.  The
fields are the same, so checkpoints written by either package decode here.
The reference service hard-codes every tunable (``src/postprocess.cpp:5-9``:
FOREGROUND_VALUE=2, kernel 3, MIN_AREA_RATIO=0.06; 512x512 input
``src/process.cpp:70``; 3-class argmax ``src/process.cpp:162``); these
dataclasses collect those defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """UNet architecture contract (see ``unetseg_tpu.config.ModelConfig``)."""

    in_channels: int = 1
    num_classes: int = 3
    base_channels: int = 64
    depth: int = 4  # number of down/up stages (bottleneck excluded)
    image_size: int = 512
    # Compute dtype; logits are returned float32 whatever it is.
    compute_dtype: str = "bfloat16"
    # Training-only in the JAX package; kept so checkpoints decode.
    remat: bool = False
    # JAX's 3x3 conv implementation switch; kept so checkpoints decode.  The
    # port always runs its own kernel (ops/conv.py) on the card.
    conv_impl: str = "xla"
    # Space-to-depth stem factor: the 512²x1 input becomes (512/stem)² x
    # stem² before the first conv, and a depth-to-space head restores 512².
    stem: int = 1
    # Model family: "unet", "unetpp" or "attention_unet" (models/registry.py).
    arch: str = "unet"
    deep_supervision: bool = False


@dataclasses.dataclass(frozen=True)
class PostprocessConfig:
    """Mask cleanup constants (reference src/postprocess.cpp:5-9)."""

    foreground_value: int = 2
    morph_kernel_size: int = 3
    min_area_ratio: float = 0.06


@dataclasses.dataclass(frozen=True)
class ContourConfig:
    """Polygon/JSON emission constants (reference src/mask2polygon.cpp:9-11)."""

    json_version: str = "1.0.2.812"
    contour_color_bgr: Tuple[int, int, int] = (0, 0, 255)
    contour_thickness: int = 1
    binary_threshold: int = 127  # src/mask2polygon.cpp:31


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline configuration."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    post: PostprocessConfig = dataclasses.field(default_factory=PostprocessConfig)
    contour: ContourConfig = dataclasses.field(default_factory=ContourConfig)
    target_size: int = 512  # src/process.cpp:70
    extensions: Tuple[str, ...] = (".raw", ".dcm", ".tif", ".tiff")
    batch_size: int = 32


DEFAULT_CONFIG = PipelineConfig()
