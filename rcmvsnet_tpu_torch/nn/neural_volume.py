"""Neural volume encoder: the backbone's stage-1 volume → the 8-channel
NeRF volume.

Counterpart of `rcmvsnet_tpu/nn/neural_volume.py`: a linear,
align_corners=True resize of the stage-1 `volume_feature_no_ref` to
`num_planes` depth planes (its h, w are kept), then the no-ReLU conv+BN
U-Net (`RenderCostReg`, here through K8). The port keeps the volume
channels-first ([B, 3(V−1)+C, D, h, w], the layout K7 writes and K8 reads)
where the JAX package keeps it channels-last. `dtype` (the render
branch's train dtype, `BackboneConfig.train_dtype`): the volume is cast to it before the
resize and the U-Net, and the result back to the input's dtype (JAX
`nn/neural_volume.py:39-49`). With `remat` the U-Net runs through
`nn/remat.remat` (JAX `nn.remat` there, `:44-45`); the resize does not.
"""
from __future__ import annotations

from functools import partial

import torch

from ..ops.sampling import resize_axis_linear
from .costreg import RenderCostReg
from .remat import remat as rematerialize


def neural_volume(cost_reg: RenderCostReg, volume_feature: torch.Tensor,
                  num_planes: int, plain: bool = False,
                  dtype: torch.dtype = torch.float32,
                  remat: bool = False) -> torch.Tensor:
    """volume_feature [B, Cv, D0, h, w] → [B, base, num_planes, h, w], in
    volume_feature's dtype, computed in `dtype`."""
    vol = resize_axis_linear(volume_feature.to(dtype), 2, num_planes,
                             align_corners=True)
    out = rematerialize(partial(cost_reg.forward_train, plain=plain),
                        [cost_reg], vol.contiguous(), enabled=remat)
    return out.to(volume_feature.dtype)
