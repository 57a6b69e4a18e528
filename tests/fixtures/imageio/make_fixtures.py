"""Writes the decoding fixtures of chip_smoke.py's phase 23 into this
directory, and hashes.json: for each file the SHA-256 of the array cv2's
imread(IMREAD_UNCHANGED) gives for it (its dtype, shape and bytes,
channels in cv2's B, G, R order; see `array_digest`) and of the JAX
package's decode_image (uint16). Run from the repository root, with cv2
installed:

    python tests/fixtures/imageio/make_fixtures.py

The frames are drawn from fixed seeds, so a rerun rewrites the same files.
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from tests import imageio_writers as writers  # noqa: E402


def array_digest(arr: np.ndarray) -> str:
    arr = np.ascontiguousarray(arr)
    head = f"{arr.dtype.str}{arr.shape}".encode()
    return hashlib.sha256(head + arr.tobytes()).hexdigest()


def frames():
    """{file name: bytes} of every fixture."""
    rs = np.random.RandomState(2022)
    y, x = np.mgrid[0:512, 0:512]
    smooth16 = (32768 + 12000 * np.sin(x / 61.0) * np.cos(y / 83.0)
                + 4000 * np.cos((x - 2 * y) / 150.0)).astype(np.uint16)
    gray = np.clip(128 + 80 * np.sin(x / 17.0) * np.cos(y / 23.0)
                   + rs.randn(512, 512) * 6, 0, 255).astype(np.uint8)
    color = np.stack([gray, np.roll(gray, 9, 1), 255 - gray], -1)
    small = color[:48, :56]
    out = {}

    def cv2_bytes(ext, img, params):
        ok, buf = cv2.imencode(ext, img, params)
        assert ok, ext
        return buf.tobytes()

    out["lzw512_u16.tif"] = cv2_bytes(".tif", smooth16, [cv2.IMWRITE_TIFF_COMPRESSION, 5])
    out["jpeg512_gray_baseline.jpg"] = cv2_bytes(".jpg", gray, [cv2.IMWRITE_JPEG_QUALITY, 90])
    out["jpeg512_color420_progressive.jpg"] = cv2_bytes(".jpg", color, [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
    for name, sf in (("422", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
                     ("440", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
                     ("411", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)):
        out[f"jpeg_color{name}_restart.jpg"] = cv2_bytes(".jpg", small, [
            cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf,
            cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    out["jpeg_gray_progressive_restart.jpg"] = cv2_bytes(".jpg", small[..., 0], [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    out["jpeg_in_tiff_rgb.tif"] = cv2_bytes(".tif", small, [cv2.IMWRITE_TIFF_COMPRESSION, 7])
    s16 = (small.astype(np.uint16) * 257)
    out["tiles_rgb16_lzw.tif"] = writers.tiff(s16, tile=(16, 32), compression=5, predictor=2)
    out["planar_rgb8_lzw.tif"] = writers.tiff(small, planar=True, compression=5, rows_per_strip=7)
    out["fill2_gray8_lzw.tif"] = writers.tiff(small[..., 0], fill_order=2, compression=5)
    out["bigtiff_be_rgb16.tif"] = writers.tiff(s16, big=True, order=">", rows_per_strip=10)
    out["old_lzw_gray16.tif"] = writers.tiff(s16[..., 1], compression=5, old_lzw=True, predictor=2)
    out["float_rgb.tif"] = cv2_bytes(".tif", (small.astype(np.float32) * 123.25 + 0.125),
                                     [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    out["adam7_rgba16.png"] = writers.png(np.concatenate(
        [s16, s16[..., :1] // 2], -1)[:37, :45], depth=16, color=6, interlace=True)
    palette = (rs.rand(16, 3) * 256).astype(np.uint8)
    index = (small[..., 0] >> 4).astype(np.uint8)
    out["palette4_trns.png"] = writers.png(index, depth=4, color=3, palette=palette,
                                           trns=[0, 64, 128])
    out["palette8_adam7.png"] = writers.png(index, color=3, palette=palette, interlace=True)
    out["gray2.png"] = writers.png((small[..., 0] >> 6).astype(np.uint8), depth=2)
    return out


def main():
    sys.path.insert(0, str(HERE.parents[2]))
    from thyroid_tpu.data.dataset import decode_image as jax_decode

    hashes = {}
    for name, data in sorted(frames().items()):
        path = HERE / name
        path.write_bytes(data)
        arr = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        assert arr is not None, name
        hashes[name] = {"cv2": array_digest(arr), "decode_image": array_digest(jax_decode(path)),
                        "shape": list(arr.shape), "dtype": arr.dtype.str}
    (HERE / "hashes.json").write_text(json.dumps(hashes, indent=1, sort_keys=True) + "\n")
    total = sum((HERE / n).stat().st_size for n in hashes)
    print(f"{len(hashes)} fixtures, {total} bytes")


if __name__ == "__main__":
    main()
