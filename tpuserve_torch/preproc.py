"""Input preprocessing, ported from ``tpuserve/preproc.py``.

Split across the host/device boundary as in the reference:

- Host (decode thread pool): byte decode only — JPEG/PNG -> uint8 RGB
  (PIL, imported inside the functions; the card's machine has no PIL, so
  there an image body answers 400 while npy and framed bodies need none),
  the native libjpeg shim for exact-size 4:2:0 JPEGs on the yuv420 wire,
  raw npy parsing. No float math beyond the yuv420 fallback's conversion.
- Device (inside the forward): resize to the model's resolution, colour
  conversion and normalisation on tensors, in float32, then one cast to the
  compute dtype. Output is NCHW-logical in ``torch.channels_last`` memory,
  the layout the cuDNN convolutions behind it take.

``jax.image.resize(method="bilinear")`` antialiases when it downscales and
not when it upscales; ``F.interpolate(mode="bilinear", align_corners=False)``
matches it with ``antialias`` on exactly when the output is smaller than the
input (``_resize``).
"""

from __future__ import annotations

import functools
import io

import numpy as np
import torch
import torch.nn.functional as F

# Wire shape edge for images: host sends (E, E, 3) uint8; device resizes to
# the model size.
DECODE_EDGE = 256

# ImageNet normalisation constants (standard publication values).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# -- host side ---------------------------------------------------------------

def decode_image(payload: bytes, content_type: str = "", edge: int = DECODE_EDGE) -> np.ndarray:
    """Bytes -> (edge, edge, 3) uint8 RGB. Runs in the decode thread pool.

    Accepts JPEG/PNG/etc via PIL, or a raw npy tensor
    (content_type == "application/x-npy") of shape (H, W, 3) uint8.
    """
    if content_type == "application/x-npy":
        arr = np.load(io.BytesIO(payload), allow_pickle=False)
        return decode_image_array(arr, edge)
    from PIL import Image

    with Image.open(io.BytesIO(payload)) as im:
        im = im.convert("RGB")
        if im.size != (edge, edge):
            im = im.resize((edge, edge), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def decode_npy_items(payload: bytes, edge: int, max_items: int):
    """npy body -> (items, is_batch) with ONE parse: a (N, H, W, 3) tensor is
    a client batch of N, an (H, W, 3) tensor a single item."""
    arr = np.load(io.BytesIO(payload), allow_pickle=False)
    if arr.ndim == 4:
        if arr.shape[0] > max_items:
            raise ValueError(
                f"batch of {arr.shape[0]} exceeds the per-request limit ({max_items})")
        return [decode_image_array(a, edge) for a in arr], True
    return [decode_image_array(arr, edge)], False


def decode_image_array(arr: np.ndarray, edge: int) -> np.ndarray:
    """In-memory (H, W, 3) uint8 -> (edge, edge, 3) uint8 (shared by the
    single-image npy body and each element of a batched (N, H, W, 3) body)."""
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"raw tensor must be (H, W, 3), got {arr.shape}")
    if arr.dtype != np.uint8:
        raise ValueError(f"raw tensor must be uint8 (0-255), got {arr.dtype}")
    if arr.shape[:2] != (edge, edge):
        arr = _resize_uint8(arr, edge)
    return arr


def _resize_uint8(img: np.ndarray, edge: int) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((edge, edge), Image.BILINEAR), dtype=np.uint8)


# Native-fallback hook: the server installs a callback that ticks
# native_decode_fallback_total{model=} whenever the libjpeg shim path was
# attempted and the slower PIL path served instead. None (tests, tools) =
# no counting.
_native_fallback_hook = None


def set_native_fallback_hook(cb) -> None:
    """Install ``cb(model_name)`` as the native-decode fallback observer
    (called from the decode threads)."""
    global _native_fallback_hook
    _native_fallback_hook = cb


def _note_native_fallback(model: str) -> None:
    cb = _native_fallback_hook
    if cb is not None:
        cb(model)


def decode_image_yuv420(payload: bytes, content_type: str, edge: int,
                        model: str = "") -> tuple:
    """Bytes -> (y, u, v) uint8 planes at the wire edge (thread pool).

    Fast path: the native libjpeg shim decodes exact-size 4:2:0 JPEGs
    straight to planes. Fallback (non-JPEG, size mismatch, no shim): PIL
    decode -> YCbCr -> numpy re-subsample, counted through the hook as
    ``native_decode_fallback_total{model=}``.
    """
    if content_type != "application/x-npy":
        from tpuserve_torch import native

        res = native.decode_yuv420(payload, edge)
        if res is not None:
            return res
        _note_native_fallback(model)
    rgb = decode_image(payload, content_type, edge=edge)
    return rgb_to_yuv420(rgb)


def rgb_to_yuv420(rgb: np.ndarray):
    """(E, E, 3) uint8 RGB -> (y, u, v) uint8 planes (BT.601 full range,
    2x2 mean-pooled chroma)."""
    f = rgb.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    e = rgb.shape[0]
    cb = cb.reshape(e // 2, 2, e // 2, 2).mean(axis=(1, 3))
    cr = cr.reshape(e // 2, 2, e // 2, 2).mean(axis=(1, 3))
    return (
        np.clip(y + 0.5, 0, 255).astype(np.uint8),
        np.clip(cb + 0.5, 0, 255).astype(np.uint8),
        np.clip(cr + 0.5, 0, 255).astype(np.uint8),
    )


# -- device side (inside the forward) ----------------------------------------

def _resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear (B, C, H, W) float32 resize to (size, size), half-pixel
    centres, antialiased when it downscales — jax.image.resize's bilinear."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=size < x.shape[-1])


@functools.lru_cache(maxsize=32)
def _norm_constants(mean: tuple, std: tuple, device: torch.device) -> tuple:
    """(1, 3, 1, 1) float32 mean and std on ``device``, made once: a fresh
    host tensor per forward would be a pageable copy that waits for the
    stream."""
    return tuple(torch.tensor(c, dtype=torch.float32, device=device).view(1, -1, 1, 1)
                 for c in (mean, std))


def _normalize(x: torch.Tensor, mean, std, dtype: torch.dtype) -> torch.Tensor:
    mean_t, std_t = _norm_constants(tuple(mean), tuple(std), x.device)
    x = (x - mean_t) / std_t
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def device_prepare_images(batch_u8: torch.Tensor, size: int, dtype=torch.bfloat16,
                          mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """(B, E, E, 3) uint8 -> (B, 3, size, size) normalised ``dtype``,
    channels_last. Scale to [0, 1], resize, normalise in float32, then cast."""
    x = batch_u8.to(torch.float32).div(255.0).permute(0, 3, 1, 2)
    if x.shape[-2:] != (size, size):
        x = _resize(x, size)
    return _normalize(x, mean, std, dtype)


def device_prepare_images_yuv420(y_u8: torch.Tensor, u_u8: torch.Tensor,
                                 v_u8: torch.Tensor, size: int, dtype=torch.bfloat16,
                                 mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """YUV 4:2:0 planes — Y (B, E, E), Cb and Cr (B, E/2, E/2) uint8 — ->
    (B, 3, size, size) normalised ``dtype``, channels_last.

    Chroma upsample (bilinear), BT.601 full-range (JFIF) YCbCr -> RGB,
    clip, resize and normalisation in float32, as in the reference."""
    e = y_u8.shape[-1]
    yf = y_u8.to(torch.float32)
    uf = _resize(u_u8.to(torch.float32)[:, None], e)[:, 0]
    vf = _resize(v_u8.to(torch.float32)[:, None], e)[:, 0]
    cb = uf - 128.0
    cr = vf - 128.0
    r = yf + 1.402 * cr
    g = yf - 0.344136 * cb - 0.714136 * cr
    bl = yf + 1.772 * cb
    x = torch.stack([r, g, bl], dim=1)
    x = torch.clamp(x, 0.0, 255.0) / 255.0
    if e != size:
        x = _resize(x, size)
    return _normalize(x, mean, std, dtype)
