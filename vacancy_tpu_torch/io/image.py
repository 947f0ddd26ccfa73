"""Image I/O and debug colorizations.

Replaces the reference's stb-backed ``Image<T, N>`` container
(``include/vacancy/image.h``) -- in numpy-land an image is just an array,
so only the I/O and visualization helpers remain
(``src/vacancy/image.cc:35-110``).
"""

from __future__ import annotations

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Load an image as a numpy array (grayscale masks stay [H, W] u8)."""
    from PIL import Image

    return np.asarray(Image.open(path))


def load_mask(path: str) -> np.ndarray:
    """Load a binary silhouette mask as uint8 [H, W] (255 = foreground)."""
    img = load_image(path)
    if img.ndim == 3:
        img = img[..., 0]
    return np.ascontiguousarray(img.astype(np.uint8))


def write_png(path: str, image: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.asarray(image)).save(path)


def depth_to_gray(
    depth: np.ndarray, min_d: float, max_d: float
) -> np.ndarray:
    """Depth -> 8-bit grayscale (reference image.cc:35-53)."""
    assert min_d < max_d
    norm = (depth - min_d) / (max_d - min_d)
    out = np.clip(norm * 255.0, 0, 255).astype(np.uint8)
    out[(depth < min_d) | (max_d < depth)] = 0
    return out

def normal_to_color(normal: np.ndarray) -> np.ndarray:
    """Unit normals [-1,1] -> RGB (reference image.cc:55-74)."""
    return np.clip(
        np.round((normal[..., :3] + 1.0) * 0.5 * 255.0), 0, 255
    ).astype(np.uint8)


def face_id_to_random_color(
    face_id: np.ndarray, seed: int = 0
) -> np.ndarray:
    """Face-id image -> per-id random colors (reference image.cc:76-110).
    id < 0 maps to black."""
    rng = np.random.default_rng(seed)
    max_id = int(face_id.max()) if face_id.size else 0
    lut = rng.integers(0, 256, size=(max(max_id + 1, 1), 3), dtype=np.int32)
    out = np.zeros(face_id.shape + (3,), np.uint8)
    valid = face_id >= 0
    out[valid] = lut[face_id[valid]].astype(np.uint8)
    return out


def convert_image(
    image: np.ndarray, dtype, scale: float = 1.0
) -> np.ndarray:
    """Scaled dtype conversion (reference Image::ConvertTo,
    image.h:132-151): dst = static_cast<TT>(scale * src), i.e. C-style
    truncation toward zero for integer targets. The multiply happens in
    float32 exactly like the reference's (scale is a float there), so
    products landing on integer boundaries truncate identically."""
    out = np.asarray(image, np.float32) * np.float32(scale)
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.integer):
        out = np.trunc(out)
    return out.astype(dtype)
