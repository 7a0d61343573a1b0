"""Host-side augmentations (numpy/cv2), the port of `cape_tpu.data.augment`.

- `resize_with_keypoints`: the deterministic resize (val/test and serving
  path), through `data.image.resize`: cv2's bilinear resize where cv2 is
  installed, the port's own bilinear resize elsewhere.
- `train_augment`: the train-time augmentation of the reference's
  albumentations list (`mp100_cape.py:898-946`), driven by an explicit
  `np.random.Generator` with the JAX package's draws in the JAX package's
  order (exact resume and byte-equal batches depend on it):
  - affine: ±10% translate, 0.85-1.15 scale, ±30° rotate, p=0.7
  - horizontal flip, p=0.5
  - colour jitter (brightness/contrast/saturation ±0.3, hue ±0.1), p=0.6
  - one of {gaussian noise, gaussian blur, motion blur}, p=0.3
  - the deterministic resize to (size, size).

The train augmentation requires cv2 (`warpAffine`, `cvtColor`, `LUT`,
`GaussianBlur`, `filter2D`) and raises where it is missing: the JAX
package's cv2-free branches (identity affine, no-op blurs, approximate hue)
would train on images that were not augmented, so the port has none.
The fused brightness/contrast/saturation step is the C++ op of `native`
(`CAPE_NATIVE=0` chooses its numpy version).

Keypoints are transformed with the image and NEVER dropped
(`remove_invisible=False`, `mp100_cape.py:940`) so index correspondence with
skeleton edges is preserved; out-of-frame keypoints simply land outside
[0, size] and are clamped at tokenization time.
"""

from __future__ import annotations

import math

import numpy as np

from .. import native
from .image import resize


def resize_with_keypoints(img, keypoints, size: int):
    """Deterministic resize (val/test path, `mp100_cape.py:943-946`)."""
    h, w = img.shape[:2]
    out = resize(img, (size, size))
    kpts = np.asarray(keypoints, dtype=np.float64).reshape(-1, 2).copy()
    kpts[:, 0] *= size / w
    kpts[:, 1] *= size / h
    return out, kpts


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "the train-time augmentation requires cv2 (opencv-python); "
            "install it, or train with augment=False (--disable_augment)"
        ) from e
    return cv2


def _affine_matrix(h, w, angle_deg, scale, tx_frac, ty_frac):
    """2x3 affine: rotate+scale about image center, then translate."""
    cx, cy = w / 2.0, h / 2.0
    a = math.radians(angle_deg)
    cos, sin = math.cos(a) * scale, math.sin(a) * scale
    return np.array(
        [
            [cos, -sin, cx - cos * cx + sin * cy + tx_frac * w],
            [sin, cos, cy - sin * cx - cos * cy + ty_frac * h],
        ],
        dtype=np.float64,
    )


def _apply_affine(img, kpts, m):
    cv2 = _cv2()
    h, w = img.shape[:2]
    out = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT)
    pts = np.concatenate([kpts, np.ones((kpts.shape[0], 1))], axis=1)
    return out, pts @ m.T


def _hue_shift(img: np.ndarray, factor: float) -> np.ndarray:
    """Shift hue by `factor` of the full color circle (uint8 RGB).

    Matches `A.ColorJitter(hue=...)` semantics: factor in [-0.5, 0.5],
    hue channel rotated modulo the circle, S/V untouched.
    """
    cv2 = _cv2()
    shift = int(round(factor * 180.0))
    if shift == 0:  # identity: skip the lossy uint8 HSV round trip
        return img
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    # one LUT pass: hue rotated mod 180 (OpenCV's hue range), S/V identity
    lut = np.empty((1, 256, 3), dtype=np.uint8)
    lut[0, :, 0] = (np.arange(256) + shift) % 180
    lut[0, :, 1] = lut[0, :, 2] = np.arange(256)
    return cv2.cvtColor(cv2.LUT(hsv, lut), cv2.COLOR_HSV2RGB)


def _color_jitter(img, rng, strength=0.3, hue_strength=0.1):
    """Brightness/contrast/saturation/hue jitter on uint8 RGB.

    Strengths match the reference `A.ColorJitter(brightness=0.3,
    contrast=0.3, saturation=0.3, hue=0.1)` (`mp100_cape.py:920-927`).
    Brightness b, contrast c and saturation s compose linearly into ONE
    per-pixel transform (`native.fused_bcs`), then the hue shift.
    """
    b = rng.uniform(1 - strength, 1 + strength)   # brightness
    c = rng.uniform(1 - strength, 1 + strength)   # contrast
    s = rng.uniform(1 - strength, 1 + strength)   # saturation
    bcs = native.fused_bcs if native.enabled() else native.fused_bcs_numpy
    x = bcs(img, float(b), float(c), float(s))
    factor = rng.uniform(-hue_strength, hue_strength)
    return _hue_shift(x, factor)


def _gauss_noise(img, rng):
    sigma = rng.uniform(5.0, 15.0)
    noise = rng.standard_normal(img.shape, dtype=np.float32) * sigma
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def _gaussian_blur(img, rng):
    cv2 = _cv2()
    k = int(rng.choice([3, 5]))
    return cv2.GaussianBlur(img, (k, k), 0)


def _motion_blur(img, rng):
    cv2 = _cv2()
    k = int(rng.choice([3, 5]))
    kernel = np.zeros((k, k), dtype=np.float32)
    if rng.uniform() < 0.5:
        kernel[k // 2, :] = 1.0 / k
    else:
        kernel[:, k // 2] = 1.0 / k
    return cv2.filter2D(img, -1, kernel)


def train_augment(img: np.ndarray, keypoints: np.ndarray, size: int,
                  rng: np.random.Generator):
    """Full training augmentation, keypoint-aware.

    Mirrors the reference list (`mp100_cape.py:898-941`): affine -> hflip ->
    color jitter -> one-of noise/blur -> resize(size, size).

    Args:
        img: (H, W, 3) uint8 RGB crop.
        keypoints: (N, 2) pixel coords in crop frame.
        size: output square size.
        rng: explicit generator (reproducible under a seeded host PRNG).
    Returns:
        (aug_img (size,size,3) uint8, keypoints (N,2) float64 in [0,size] frame)
    """
    _cv2()  # raise before any draw where cv2 is missing
    kpts = np.asarray(keypoints, dtype=np.float64).reshape(-1, 2).copy()
    h, w = img.shape[:2]

    if rng.uniform() < 0.7:
        m = _affine_matrix(
            h,
            w,
            angle_deg=rng.uniform(-30, 30),
            scale=rng.uniform(0.85, 1.15),
            tx_frac=rng.uniform(-0.1, 0.1),
            ty_frac=rng.uniform(-0.1, 0.1),
        )
        img, kpts = _apply_affine(img, kpts, m)

    if rng.uniform() < 0.5:
        img = img[:, ::-1].copy()
        kpts[:, 0] = (w - 1) - kpts[:, 0]

    if rng.uniform() < 0.6:
        img = _color_jitter(img, rng)

    if rng.uniform() < 0.3:
        img = [_gauss_noise, _gaussian_blur, _motion_blur][int(rng.integers(3))](img, rng)

    return resize_with_keypoints(img, kpts, size)
