"""Host-side numpy image transforms (torch/torchvision-free).

Parity targets:
  * ColorJitter(brightness=1, contrast=1, saturation=0.5, hue=0.5) +
    RandomGamma(0.5, 2.0, clip) + ImageNet normalize
      — the reference's datasets/dtu_train.py:100-109,
        the reference's datasets/utils.py:42-61
  * center_image (per-image mean/std) — dtu_train.py:156-161
  * prepare_img crop pipeline — dtu_train.py:164-179
"""
from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_imagenet(img: np.ndarray) -> np.ndarray:
    """[0,1] float RGB HWC → ImageNet-normalized."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def center_image(img: np.ndarray) -> np.ndarray:
    """Per-image mean/variance normalization (over H, W jointly per channel
    — matching np.var(axis=(0,1)) at dtu_train.py:156-161). Input [0,255]
    or [0,1]; the normalization makes the scale irrelevant up to epsilon."""
    img = img.astype(np.float32)
    var = np.var(img, axis=(0, 1), keepdims=True)
    mean = np.mean(img, axis=(0, 1), keepdims=True)
    return (img - mean) / (np.sqrt(var) + 1e-8)


def _blend(a, b, f):
    return f * a + (1 - f) * b


def _rgb_to_gray(img):
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]


def _adjust_hue(img, factor):
    """Shift hue by factor∈[-0.5, 0.5] turns via HSV round trip."""
    import cv2
    hsv = cv2.cvtColor(img.clip(0, 1), cv2.COLOR_RGB2HSV)
    hsv[..., 0] = (hsv[..., 0] + factor * 360.0) % 360.0
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def color_jitter(rs: np.random.RandomState, img: np.ndarray,
                 brightness: float = 1.0, contrast: float = 1.0,
                 saturation: float = 0.5, hue: float = 0.5) -> np.ndarray:
    """torchvision-style jitter: random factors, random op order.

    img: [0,1] float RGB HWC. Factor ranges follow torchvision semantics:
    brightness/contrast ~ U(max(0, 1−x), 1+x), saturation ~ U(1−x, 1+x),
    hue ~ U(−x, x).
    """
    fb = rs.uniform(max(0.0, 1 - brightness), 1 + brightness)
    fc = rs.uniform(max(0.0, 1 - contrast), 1 + contrast)
    fs = rs.uniform(max(0.0, 1 - saturation), 1 + saturation)
    fh = rs.uniform(-hue, hue)

    ops = [
        lambda x: (x * fb).clip(0, 1),
        lambda x: _blend(x, _rgb_to_gray(x).mean(), fc).clip(0, 1),
        lambda x: _blend(x, _rgb_to_gray(x), fs).clip(0, 1),
        lambda x: _adjust_hue(x, fh),
    ]
    for i in rs.permutation(4):
        img = ops[i](img.astype(np.float32))
    return img.astype(np.float32)


def random_gamma(rs: np.random.RandomState, img: np.ndarray,
                 min_gamma: float = 0.5, max_gamma: float = 2.0,
                 clip: bool = True) -> np.ndarray:
    gamma = rs.uniform(min_gamma, max_gamma)
    out = np.power(img.clip(0, None), gamma)
    return out.clip(0.0, 1.0) if clip else out


def prepare_img(hr_img: np.ndarray) -> np.ndarray:
    """1600×1200 → ½ downsample (nearest) → center-ish crop to 512×640.

    Matches dtu_train.py:164-179 (used for Depths_raw GT/mask pyramids).
    """
    import cv2
    h, w = hr_img.shape
    ds = cv2.resize(hr_img, (w // 2, h // 2), interpolation=cv2.INTER_NEAREST)
    h, w = ds.shape
    target_h, target_w = 512, 640
    start_h, start_w = (h - target_h) // 2, (w - target_w) // 2
    return ds[start_h:start_h + target_h, start_w:start_w + target_w]


def stage_pyramid(img2d: np.ndarray) -> dict:
    """{stage1: ¼, stage2: ½, stage3: full} nearest-resized pyramid."""
    import cv2
    h, w = img2d.shape
    return {
        "stage1": cv2.resize(img2d, (w // 4, h // 4), interpolation=cv2.INTER_NEAREST),
        "stage2": cv2.resize(img2d, (w // 2, h // 2), interpolation=cv2.INTER_NEAREST),
        "stage3": img2d,
    }


def scaled_mvs_dims(h: int, w: int, max_w: int, max_h: int,
                    base: int = 32):
    """The (new_h, new_w) scale_mvs_input produces for an (h, w) image."""
    if h > max_h or w > max_w:
        scale = 1.0 * max_h / h
        if scale * w > max_w:
            scale = 1.0 * max_w / w
        new_w, new_h = scale * w // base * base, scale * h // base * base
    else:
        new_w, new_h = 1.0 * w // base * base, 1.0 * h // base * base
    return int(new_h), int(new_w)


def scale_mvs_intrinsics(intrinsics: np.ndarray, h: int, w: int,
                         new_h: int, new_w: int) -> np.ndarray:
    intrinsics = intrinsics.copy()
    intrinsics[0, :] *= 1.0 * new_w / w
    intrinsics[1, :] *= 1.0 * new_h / h
    return intrinsics


def scale_mvs_input(img: np.ndarray, intrinsics: np.ndarray,
                    max_w: int, max_h: int, base: int = 32):
    """Scale to ≤(max_w, max_h), rounded down to a multiple of `base`,
    updating intrinsics. Matches dtu_test.py:131-148. An image already at
    its scaled size is returned as it is (cv2.resize would copy it), so
    that path needs no cv2."""
    h, w = img.shape[:2]
    new_h, new_w = scaled_mvs_dims(h, w, max_w, max_h, base)
    intrinsics = scale_mvs_intrinsics(intrinsics, h, w, new_h, new_w)
    if (new_h, new_w) != (h, w):
        import cv2
        img = cv2.resize(img, (new_w, new_h))
    return img, intrinsics
