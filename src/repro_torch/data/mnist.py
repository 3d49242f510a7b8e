"""Procedural MNIST — a deterministic synthetic stand-in.

A numpy copy of ``repro.data.mnist``: 10 glyph bitmaps -> random affine
(shift/rotate/scale/shear) -> bilinear resample -> stroke-intensity jitter +
Gaussian noise. The same seed gives byte-identical arrays in both packages,
so the port is checked on exactly the images the JAX package saw
(``load("test")`` is ``generate(10000, 1235)``).
"""

from __future__ import annotations

import numpy as np

_GLYPHS = {  # 7x5 classic bitmap font
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _glyph_images() -> np.ndarray:
    """(10, 28, 28) float32 smoothed glyph templates."""
    out = np.zeros((10, 28, 28), np.float32)
    for d, rows in _GLYPHS.items():
        bmp = np.array([[int(c) for c in r] for r in rows], np.float32)  # 7x5
        big = np.kron(bmp, np.ones((3, 3), np.float32))                  # 21x15
        img = np.zeros((28, 28), np.float32)
        img[3:24, 6:21] = big
        # cheap 3x3 box blur for stroke softness
        pad = np.pad(img, 1)
        img = sum(pad[i:i + 28, j:j + 28] for i in range(3) for j in range(3)) / 9
        out[d] = np.clip(img * 1.6, 0, 1)
    return out


def _affine_batch(imgs: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Random affine per image with vectorized bilinear resampling."""
    B = imgs.shape[0]
    ang = rng.uniform(-0.30, 0.30, B)                 # ~±17 deg
    scale = rng.uniform(0.80, 1.20, B)
    shear = rng.uniform(-0.25, 0.25, B)
    tx = rng.uniform(-2.5, 2.5, B)
    ty = rng.uniform(-2.5, 2.5, B)
    c, s = np.cos(ang) / scale, np.sin(ang) / scale
    # inverse map: dest (x,y) -> src coords, centered at 13.5
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    xc, yc = (xx - 13.5).ravel(), (yy - 13.5).ravel()           # (784,)
    sx = c[:, None] * xc + (s[:, None] + shear[:, None]) * yc + 13.5 - tx[:, None]
    sy = -s[:, None] * xc + c[:, None] * yc + 13.5 - ty[:, None]
    x0 = np.floor(sx).astype(np.int32)
    y0 = np.floor(sy).astype(np.int32)
    fx, fy = sx - x0, sy - y0

    def grab(yi, xi):
        yi = np.clip(yi, 0, 27)
        xi = np.clip(xi, 0, 27)
        return imgs[np.arange(B)[:, None], yi, xi]

    out = (grab(y0, x0) * (1 - fx) * (1 - fy) + grab(y0, x0 + 1) * fx * (1 - fy)
           + grab(y0 + 1, x0) * (1 - fx) * fy + grab(y0 + 1, x0 + 1) * fx * fy)
    return out.reshape(B, 28, 28)


def generate(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images (n, 784) float32 in [0,1], labels (n,) int32)."""
    rng = np.random.RandomState(seed)
    glyphs = _glyph_images()
    labels = rng.randint(0, 10, n).astype(np.int32)
    base = glyphs[labels]
    imgs = _affine_batch(base, rng)
    imgs *= rng.uniform(0.7, 1.0, (n, 1, 1))                    # stroke intensity
    imgs += rng.normal(0, 0.08, imgs.shape)                     # sensor noise
    imgs = np.clip(imgs, 0, 1).astype(np.float32)
    return imgs.reshape(n, 784), labels


def load(split: str = "train", n_train: int = 60_000, n_test: int = 10_000,
         seed: int = 1234) -> tuple[np.ndarray, np.ndarray]:
    """The same splits as ``repro.data.mnist.load`` (train = ``generate(
    n_train, seed)``, test = ``generate(n_test, seed + 1)``), generated on
    each call instead of cached on disk: the port writes nothing outside
    its checkout, and the 10,000-image test split takes about a second."""
    if split == "train":
        return generate(n_train, seed)
    return generate(n_test, seed + 1)
