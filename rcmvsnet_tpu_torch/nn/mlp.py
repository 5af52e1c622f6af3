"""NeRF MLPs of the render branch (net_type 'v0', 'v1', 'v2') and their
positional encoding.

Counterparts of `rcmvsnet_tpu/nn/mlp.py`:
  * `NerfMLP`: D=6, W=128, skip after layer 4,
    h = relu(linear(h) · pts_bias(feat)) ('v0', bias_mode "multiply") or
    relu(linear(h) + pts_bias(feat)) ('v2', "add"), view head
    alpha = relu(linear(h)),
    rgb = sigmoid(linear(relu(linear([feature_linear(h), views]))));
  * `MultiHeadAttention`: 4 heads, d_k = d_v = 4, bias-free q/k/v/fc
    projections, temperature √d_k, residual then LayerNorm (eps 1e-6);
  * `AttentionNerfMLP` ('v1'): the 3 source views' (rgba ⊕ 8 volume
    channels) tokens attend to each other, sigmoid(weight_out) summed over
    the views gives a color prior; additive conditioning on
    [volume channels, prior], no skip; returns [rgb, σ, prior, prior]
    ([..., 10]: the reference concatenates the prior twice).
Parameter names are the reference's (`pts_linears.{i}`, `pts_bias`,
`views_linears.0`, `feature_linear`, `alpha_linear`, `rgb_linear`,
`color_attention.{w_qs,w_ks,w_vs,fc,layer_norm}`, `weight_out`); linear
weights are kaiming-normal with zero bias except `pts_bias`, the attention
block and `weight_out` (torch's default), as the reference initializes
them.
"""
from __future__ import annotations

import math

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


def _view_head(module: nn.Module, width: int, in_ch_views: int):
    module.views_linears = nn.ModuleList(
        [_kaiming(nn.Linear(width + in_ch_views, width // 2))])
    module.feature_linear = _kaiming(nn.Linear(width, width))
    module.alpha_linear = _kaiming(nn.Linear(width, 1))
    module.rgb_linear = _kaiming(nn.Linear(width // 2, 3))


def _rgb_alpha(module: nn.Module, h: torch.Tensor, views: torch.Tensor):
    alpha = torch.relu(module.alpha_linear(h))
    h = torch.cat([module.feature_linear(h), views], dim=-1)
    h = torch.relu(module.views_linears[0](h))
    return torch.sigmoid(module.rgb_linear(h)), alpha


class NerfMLP(nn.Module):
    def __init__(self, depth: int = 6, width: int = 128, in_ch_pts: int = 63,
                 in_ch_feat: int = 20, in_ch_views: int = 3,
                 skips=(4,), bias_mode: str = "multiply"):
        super().__init__()
        if bias_mode not in ("multiply", "add"):
            raise ValueError(f"bias_mode {bias_mode!r}")
        self.skips = tuple(skips)
        self.bias_mode = bias_mode
        self.pts_linears = nn.ModuleList(
            [_kaiming(nn.Linear(in_ch_pts, width))]
            + [_kaiming(nn.Linear(width + (in_ch_pts if i in self.skips
                                           else 0), width))
               for i in range(depth - 1)])
        self.pts_bias = nn.Linear(in_ch_feat, width)
        _view_head(self, width, in_ch_views)

    def forward(self, pts: torch.Tensor, feats: torch.Tensor,
                views: torch.Tensor) -> torch.Tensor:
        """pts [..., 63], feats [..., F], views [..., 3] → [..., 4]."""
        h = pts
        bias = self.pts_bias(feats)
        mul = self.bias_mode == "multiply"
        for i, layer in enumerate(self.pts_linears):
            h = torch.relu(layer(h) * bias if mul else layer(h) + bias)
            if i in self.skips:
                h = torch.cat([pts, h], dim=-1)
        rgb, alpha = _rgb_alpha(self, h, views)
        return torch.cat([rgb, alpha], dim=-1)


class MultiHeadAttention(nn.Module):
    """Residual multi-head attention + LayerNorm over the token axis (the
    second to last)."""

    def __init__(self, d_model: int, n_head: int = 4, d_k: int = 4,
                 d_v: int = 4):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_qs = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_ks = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_vs = nn.Linear(d_model, n_head * d_v, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        """q, k, v [..., L, d_model] → ([..., L, d_model], attention
        [..., H, L, L])."""
        *lead, L, _ = q.shape

        def split(t, d):                               # [..., H, L, d]
            return t.reshape(*lead, L, self.n_head, d).transpose(-2, -3)

        qh = split(self.w_qs(q), self.d_k)
        kh = split(self.w_ks(k), self.d_k)
        vh = split(self.w_vs(v), self.d_v)
        attn = torch.softmax(
            (qh / math.sqrt(self.d_k)) @ kh.transpose(-1, -2), dim=-1)
        out = (attn @ vh).transpose(-3, -2).reshape(
            *lead, L, self.n_head * self.d_v)
        return self.layer_norm(self.fc(out) + q), attn


class AttentionNerfMLP(nn.Module):
    """net_type 'v1'. feats = [8 volume channels ⊕ n_src·4 warped rgba].
    The trunk is built as the reference builds it, by list replication:
    layers 1..depth−1 are one shared `nn.Linear` (state_dict keys
    `pts_linears.1..depth−1` name the same tensor)."""

    VOLUME_CH = 8

    def __init__(self, depth: int = 6, width: int = 128, in_ch_pts: int = 63,
                 in_ch_feat: int = 20, in_ch_views: int = 3):
        super().__init__()
        self.n_src = (in_ch_feat - self.VOLUME_CH) // 4
        d_model = 4 + self.VOLUME_CH
        self.color_attention = MultiHeadAttention(d_model)
        self.weight_out = nn.Linear(d_model, 3)
        shared = _kaiming(nn.Linear(width, width))
        self.pts_linears = nn.ModuleList(
            [_kaiming(nn.Linear(in_ch_pts, width))] + [shared] * (depth - 1))
        self.pts_bias = nn.Linear(self.VOLUME_CH + 3, width)
        _view_head(self, width, in_ch_views)

    def forward(self, pts: torch.Tensor, feats: torch.Tensor,
                views: torch.Tensor) -> torch.Tensor:
        """pts [..., 63], feats [..., F], views [..., 3] → [..., 10]."""
        lead, n = feats.shape[:-1], self.n_src
        feat8 = feats[..., :self.VOLUME_CH]
        tokens = torch.cat(
            [feats[..., self.VOLUME_CH:].reshape(*lead, n, 4),
             feat8[..., None, :].expand(*lead, n, self.VOLUME_CH)], dim=-1)
        tokens, _ = self.color_attention(tokens, tokens, tokens)
        colors = torch.sigmoid(self.weight_out(tokens)).sum(-2)
        bias = self.pts_bias(torch.cat([feat8, colors], dim=-1))
        h = pts
        for layer in self.pts_linears:
            h = torch.relu(layer(h) + bias)
        rgb, alpha = _rgb_alpha(self, h, views)
        return torch.cat([rgb, alpha, colors, colors], dim=-1)
