"""Configuration of the port: the cascade's shape knobs, and the train
step's render, loss and run settings.

Counterparts of `rcmvsnet_tpu/config.py` without the TPU knobs (`pallas_*`,
`ray_major_lookup`) and the multi-device one (`n_devices`): the port picks
its kernels by the tensor's device. `RunConfig.remat` and `remat_modules`
keep JAX's meanings and defaults (`nn/remat.py`). It computes in float32,
except where a dtype field names bfloat16, with JAX's fields and meanings:
  * `BackboneConfig.eval_dtype`: the eval path's conv stacks and warp in
    bf16; geometry, softmax and depth regression float32;
  * `BackboneConfig.train_dtype`: the train forward's FeatureNet, warps
    (K1/K6, K7) and CostRegNet U-Nets (K8) in bf16, and so are the render
    branch's neural-volume resize and U-Net (JAX's `RenderConfig.
    train_dtype`, which its CLI sets from the same flag); parameters,
    Adam's moments, BatchNorm statistics, the variance sums, softmax,
    depth regression, the render MLP, ray sampling, compositing and the
    losses float32.
None (or "float32") means float32; "bfloat16" is the only other value.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class BackboneConfig:
    ndepths: Tuple[int, ...] = (48, 32, 8)
    depth_intervals_ratio: Tuple[float, ...] = (4.0, 2.0, 1.0)
    cr_base_chs: Tuple[int, ...] = (8, 8, 8)
    base_channels: int = 8
    grad_detach: bool = True
    # eval compute dtype ('bfloat16': K5, K1 and K2 in their bf16
    # instances, the path the JAX eval CLI runs on its chip); None (or
    # 'float32') = float32
    eval_dtype: Optional[str] = None
    # train compute dtype of the backbone and of the render U-Net
    # ('bfloat16': FeatureNet, the train warps and the U-Nets on bf16
    # activations through the bf16 instances of K1, K6, K7, K2 and K8 dw);
    # None (or 'float32') = float32
    train_dtype: Optional[str] = None


@dataclass(frozen=True)
class RenderConfig:
    """The render branch's sizes and MLP variant (its widths are constants
    of `models/render_net.py`)."""
    n_rays: int = 1024
    n_samples: int = 128
    num_planes: int = 128
    net_type: str = "v0"  # 'v0' mult feat bias | 'v1' attention | 'v2' additive


# a dtype field's value → the torch dtype it names
DTYPES = {None: torch.float32, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def compute_dtype(name: Optional[str]) -> torch.dtype:
    """The torch dtype a config dtype field names (None: float32)."""
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {list(DTYPES)}, got "
                         f"{name!r}")
    return DTYPES[name]


@dataclass(frozen=True)
class LossConfig:
    dlossw: Tuple[float, ...] = (0.5, 1.0, 2.0)
    w_aug: float = 0.01


@dataclass(frozen=True)
class DataConfig:
    """Where the train and val sets come from and their shapes. datapath
    is a DTU tree or 'synthetic'; testpath (the val set's tree) defaults
    to datapath."""
    datapath: str = ""
    testpath: str = ""
    train_list: str = "lists/dtu/train.txt"
    test_list: str = "lists/dtu/test.txt"
    num_views: int = 4          # 1 ref + 3 src (train)
    eval_num_views: int = 5
    numdepth: int = 192
    interval_scale: float = 1.06


@dataclass(frozen=True)
class RunConfig:
    epochs: int = 15
    lr: float = 1e-4
    lr_milestone_epochs: Tuple[int, ...] = (10, 12, 14)
    lr_gamma: float = 0.5
    weight_decay: float = 0.0
    batch_size: int = 1
    # rematerialize the train step's three passes (clean, aug, render) in
    # the backward (`train/step.py`): each pass keeps its inputs and
    # outputs across the gradient, not its activations; the recompute
    # changes no number the step returns and no BatchNorm buffer
    remat: bool = True
    # also rematerialize FeatureNet, each CostRegNet and the render U-Net
    # inside each pass: on top of the pass-level recompute each of them
    # runs its forward three times a step (twice with this off), for the
    # lowest peak memory. Ignored when remat is False.
    remat_modules: bool = True
    seed: int = 1
    logdir: str = "./rc-mvsnet"
    save_freq: int = 1
    eval_freq: int = 1
    summary_freq: int = 10


@dataclass(frozen=True)
class Config:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)
