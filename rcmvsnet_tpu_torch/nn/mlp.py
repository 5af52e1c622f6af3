"""NeRF MLP of the render branch (net_type 'v0') and its positional
encoding.

Counterpart of `rcmvsnet_tpu/nn/mlp.py` `positional_encoding` and
`NerfMLP(bias_mode="multiply")`: D=6, W=128, skip after layer 4,
h = relu(linear(h) · pts_bias(feat)), view head alpha = relu(linear(h)),
rgb = sigmoid(linear(relu(linear([feature_linear(h), views])))).
Parameter names are the reference's (`pts_linears.{i}`, `pts_bias`,
`views_linears.0`, `feature_linear`, `alpha_linear`, `rgb_linear`); linear
weights are kaiming-normal with zero bias except `pts_bias` (torch's
default), as the reference initializes them.
"""
from __future__ import annotations

import torch
from torch import nn


def positional_encoding(x: torch.Tensor, num_freqs: int = 10):
    """[..., d] → [..., d + 2·d·num_freqs]: [x, sin(2^k x), cos(2^k x)],
    frequencies major, coordinates minor."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    scaled = (x[..., None, :] * freqs[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(scaled), torch.cos(scaled)], dim=-1)


def _kaiming(layer: nn.Linear) -> nn.Linear:
    nn.init.kaiming_normal_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


class NerfMLP(nn.Module):
    def __init__(self, depth: int = 6, width: int = 128, in_ch_pts: int = 63,
                 in_ch_feat: int = 20, in_ch_views: int = 3,
                 skips=(4,)):
        super().__init__()
        self.skips = tuple(skips)
        self.pts_linears = nn.ModuleList(
            [_kaiming(nn.Linear(in_ch_pts, width))]
            + [_kaiming(nn.Linear(width + (in_ch_pts if i in self.skips
                                           else 0), width))
               for i in range(depth - 1)])
        self.pts_bias = nn.Linear(in_ch_feat, width)
        self.views_linears = nn.ModuleList(
            [_kaiming(nn.Linear(width + in_ch_views, width // 2))])
        self.feature_linear = _kaiming(nn.Linear(width, width))
        self.alpha_linear = _kaiming(nn.Linear(width, 1))
        self.rgb_linear = _kaiming(nn.Linear(width // 2, 3))

    def forward(self, pts: torch.Tensor, feats: torch.Tensor,
                views: torch.Tensor) -> torch.Tensor:
        """pts [..., 63], feats [..., F], views [..., 3] → [..., 4]."""
        h = pts
        bias = self.pts_bias(feats)
        for i, layer in enumerate(self.pts_linears):
            h = torch.relu(layer(h) * bias)
            if i in self.skips:
                h = torch.cat([pts, h], dim=-1)
        alpha = torch.relu(self.alpha_linear(h))
        h = torch.cat([self.feature_linear(h), views], dim=-1)
        h = torch.relu(self.views_linears[0](h))
        rgb = torch.sigmoid(self.rgb_linear(h))
        return torch.cat([rgb, alpha], dim=-1)
