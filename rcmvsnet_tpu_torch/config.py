"""Backbone configuration of the port: the cascade's shape knobs only.

Counterpart of `rcmvsnet_tpu.config.BackboneConfig` without the TPU knobs
(`pallas_*`, `eval_dtype`, `train_*`, `remat`): the port picks its kernels
by the tensor's device, and it computes in float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class BackboneConfig:
    ndepths: Tuple[int, ...] = (48, 32, 8)
    depth_intervals_ratio: Tuple[float, ...] = (4.0, 2.0, 1.0)
    cr_base_chs: Tuple[int, ...] = (8, 8, 8)
    base_channels: int = 8
