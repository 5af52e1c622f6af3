"""Projective geometry for plane-sweep MVS, in PyTorch (float32).

Counterpart of `rcmvsnet_tpu/core/geometry.py:21-82` and of its
`world_to_ndc` (`:120`), which the render branch uses. The JAX code pins
these products to f32 `HIGHEST`; on the card the port relies on
`torch.backends.cuda.matmul.allow_tf32 = False` (the default, and set again
by `set_full_precision`), so a 4x4 product never drops to TF32.
"""
from __future__ import annotations

import torch


def set_full_precision() -> None:
    """Keep every float32 matmul and cuDNN convolution in full float32.

    cuDNN's default on Hopper is TF32 (about three decimal digits), which
    shifts K-folded sample coordinates and breaks plain-vs-kernel parity."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def compose_projection(proj_pair: torch.Tensor) -> torch.Tensor:
    """[..., 2, 4, 4] {extrinsic E, intrinsic K} → [..., 4, 4]: E with its
    top three rows replaced by K @ E[:3, :4]."""
    extr = proj_pair[..., 0, :, :]
    intr = proj_pair[..., 1, :3, :3]
    top = torch.matmul(intr, extr[..., :3, :4])
    return torch.cat([top, extr[..., 3:4, :]], dim=-2)


def relative_projection(src_proj: torch.Tensor,
                        ref_proj: torch.Tensor) -> torch.Tensor:
    """src @ inv(ref): maps ref-camera homogeneous pixels·depth to src."""
    return torch.matmul(src_proj, torch.linalg.inv(ref_proj))


def pixel_grid(height: int, width: int, device=None,
               dtype=torch.float32) -> torch.Tensor:
    """Homogeneous pixel coordinates [(x, y, 1)] of shape [3, H*W],
    row-major over (y, x)."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                            torch.arange(width, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.ones(height * width, dtype=dtype,
                                   device=device)])


def project_to_grid(proj: torch.Tensor, depth_values: torch.Tensor,
                    height: int, width: int):
    """Where does each (ref pixel, depth) land in the source view?

    proj: [B, 4, 4] relative projection; depth_values: [B, D] or
    [B, D, H, W]. Returns normalized coords (x, y), each [B, D, H*W], in
    the align_corners=True convention (±1 are the centres of pixels 0 and
    size-1)."""
    B = proj.shape[0]
    D = depth_values.shape[1]
    rot = proj[:, :3, :3]
    trans = proj[:, :3, 3:4]
    xyz = pixel_grid(height, width, device=proj.device)        # [3, H*W]
    rot_xyz = torch.matmul(rot, xyz)                            # [B, 3, H*W]
    depth = depth_values.reshape(B, 1, D, -1)
    proj_xyz = rot_xyz[:, :, None, :] * depth + trans[:, :, None, :]
    # |z| < 1e-6 is pushed away from 0: the coordinates then land far
    # outside the image and the zeros-padded sampler drops them
    z = proj_xyz[:, 2:3]
    eps = torch.where(z < 0, torch.full_like(z, -1e-6),
                      torch.full_like(z, 1e-6))
    z = torch.where(z.abs() < 1e-6, eps, z)
    proj_xy = proj_xyz[:, :2] / z                               # [B,2,D,H*W]
    x_norm = proj_xy[:, 0] / ((width - 1) / 2.0) - 1.0
    y_norm = proj_xy[:, 1] / ((height - 1) / 2.0) - 1.0
    return x_norm, y_norm


def world_to_ndc(points: torch.Tensor, w2c_ref: torch.Tensor,
                 intrinsic_ref: torch.Tensor, inv_scale: torch.Tensor,
                 near, far) -> torch.Tensor:
    """World points → reference-view NDC in [0, 1]^3.

    points [..., 3]; w2c_ref [4, 4]; intrinsic_ref [3, 3]; inv_scale [2] =
    (W-1, H-1). xy are projected pixels normalized by inv_scale, z is
    (z - near) / (far - near). The JAX function's `pad` squeeze is not
    ported: no configuration sets it."""
    shape = points.shape
    pts = points.reshape(-1, 3)
    pts = torch.matmul(pts, w2c_ref[:3, :3].T) + w2c_ref[:3, 3][None]
    pix = torch.matmul(pts, intrinsic_ref.T)
    xy = (pix[:, :2] / pix[:, 2:3]) / inv_scale.reshape(1, 2)
    z = (pix[:, 2:3] - near) / (far - near)
    return torch.cat([xy, z], dim=-1).reshape(shape)
