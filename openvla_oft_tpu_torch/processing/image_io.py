"""One reader for the image files the JAX package opens with
`PIL.Image.open(...).convert("RGB")`: JPEG and PNG, by their magic bytes.

    read_image(data, idct="islow") -> uint8 (H, W, 3)

A JPEG goes to the host library's decoder (`processing/jpeg_decode.py`:
baseline, extended and progressive Huffman-coded streams, every integral
sampling layout, grey, YCbCr, Adobe RGB, CMYK and YCCK); `idct="islow"`
gives PIL's pixels, "ifast" TF's. A PNG goes to `processing/png_decode.py`
(PIL's pixels). GIF, BMP, WebP and TIFF raise naming the format, as does
anything else.
"""

from __future__ import annotations

import numpy as np

_OTHER = ((b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"),
          (b"MM\x00*", "TIFF"))


def image_format(data: bytes) -> str:
    """"JPEG", "PNG", or the name of a format the reader refuses."""
    from openvla_oft_tpu_torch.processing.png_decode import SIGNATURE

    if data[:2] == b"\xff\xd8":
        return "JPEG"
    if data[:8] == SIGNATURE:
        return "PNG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _OTHER:
        if data[:len(magic)] == magic:
            return name
    return "unknown"


def read_image(data: bytes, idct: str = "islow") -> np.ndarray:
    """Image file bytes -> uint8 (H, W, 3) RGB, `Image.open(...).convert("RGB")`'s
    pixels (a JPEG under `idct="ifast"`: `tf.io.decode_jpeg`'s)."""
    data = bytes(data)
    kind = image_format(data)
    if kind == "JPEG":
        from openvla_oft_tpu_torch.processing.jpeg_decode import decode_jpeg

        return decode_jpeg(data, idct=idct)
    if kind == "PNG":
        from openvla_oft_tpu_torch.processing.png_decode import decode_png

        return decode_png(data)
    if kind == "unknown":
        raise ValueError(f"unsupported image format (first bytes {data[:8].hex()}): the "
                         "reader takes JPEG and PNG")
    raise ValueError(f"unsupported image format: {kind} (the reader takes JPEG and PNG)")
