"""Neural volume encoder: the backbone's stage-1 volume → the 8-channel
NeRF volume.

Counterpart of `rcmvsnet_tpu/nn/neural_volume.py`: a linear,
align_corners=True resize of the stage-1 `volume_feature_no_ref` to
`num_planes` depth planes (its h, w are kept), then the no-ReLU conv+BN
U-Net (`RenderCostReg`, here through K8). The port keeps the volume
channels-first ([B, 3(V−1)+C, D, h, w], the layout K7 writes and K8 reads)
where the JAX package keeps it channels-last.
"""
from __future__ import annotations

import torch

from ..ops.sampling import resize_axis_linear
from .costreg import RenderCostReg


def neural_volume(cost_reg: RenderCostReg, volume_feature: torch.Tensor,
                  num_planes: int, plain: bool = False) -> torch.Tensor:
    """volume_feature [B, Cv, D0, h, w] → [B, base, num_planes, h, w]."""
    vol = resize_axis_linear(volume_feature, 2, num_planes,
                             align_corners=True)
    return cost_reg.forward_train(vol.contiguous(), plain=plain)
