"""The port's decoder and PNG writer (thyroid_tpu_torch.data.imageio) against
cv2 and the JAX package's decode chain, on the CPU. Every comparison is
pixel-equal: the 16 committed PNGs, PNGs this file builds by hand with
each of the five row filters (and a mix) at 8 and 16 bits in gray, gray +
alpha, RGB and RGBA, TIFFs that cv2 writes uncompressed, LZW, Deflate and
PackBits in one strip and in many, and `encode_png` read back by cv2."""
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from thyroid_tpu.data.dataset import CARSThyroidDataset as JaxDataset
from thyroid_tpu.data.dataset import decode_image as jax_decode
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.data import imageio
from thyroid_tpu_torch.data.dataset import CARSThyroidDataset
from thyroid_tpu_torch.data.synthetic import generate_image

ROOT = Path(__file__).resolve().parents[1]
TINY = sorted((ROOT / "data" / "synthetic_tiny").glob("*/*.png"))
COLOR = {1: 0, 2: 4, 3: 2, 4: 6}           # channels → PNG colour type


def _cv2_order(img: np.ndarray) -> np.ndarray:
    """File order (R, G, B[, A]) → cv2's (B, G, R[, A]); gray stays."""
    if img.ndim == 2 or img.shape[-1] == 2:
        return img
    return img[..., [2, 1, 0] + ([3] if img.shape[-1] == 4 else [])]


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png(img: np.ndarray, filters, interlace: int = 0, color=None) -> bytes:
    """A PNG of `img` (H, W[, C]) built byte by byte, row r filtered with
    filters[r] — the loop version of the filters, as the PNG spec states
    them."""
    img = img if img.ndim == 3 else img[..., None]
    h, w, ch = img.shape
    depth = 8 * img.dtype.itemsize
    raw = img.astype(img.dtype.newbyteorder(">")).tobytes()
    stride = w * ch * img.dtype.itemsize
    bpp = ch * img.dtype.itemsize
    out = bytearray()
    prev = bytes(stride)
    for r in range(h):
        line = raw[r * stride:(r + 1) * stride]
        ftype = filters[r]
        out.append(ftype)
        for x in range(stride):
            a = line[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
            out.append((line[x] - pred) & 0xFF)
        prev = line

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    header = struct.pack(">IIBBBBB", w, h, depth,
                         COLOR[ch] if color is None else color, 0, 0, interlace)
    return (imageio.PNG_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(bytes(out), 6)) + chunk(b"IEND", b""))


@pytest.mark.unit
@pytest.mark.parametrize("path", TINY, ids=lambda p: p.name)
def test_committed_pngs_decode_like_cv2(path):
    """Each committed frame: cv2's pixels, JAX's decode_image, and the
    generator's frame (seed = 42·1,000,003 + class·100,000 + i, 512²)."""
    got = imageio.decode_png(path.read_bytes())
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imageio.decode_image(path), jax_decode(path))
    label = int(path.parent.name == "cancerous")
    i = int(path.stem.split("_")[-1])
    np.testing.assert_array_equal(
        got, generate_image(42 * 1_000_003 + label * 100_000 + i, label, 512))


FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4, "mixed": None}


@pytest.mark.unit
@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["gray", "gray-alpha",
                                                         "rgb", "rgba"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["8bit", "16bit"])
@pytest.mark.parametrize("filt", list(FILTERS))
def test_hand_built_png_decodes_like_cv2(filt, dtype, channels, tmp_path):
    rs = np.random.RandomState(channels * 10 + FILTERS[filt] if FILTERS[filt]
                               is not None else 99)
    h, w = 9, 13
    top = np.iinfo(dtype).max
    img = (rs.rand(h, w, channels) * (top + 1)).astype(dtype)
    img[0, :3] = top            # wrap-arounds in every filter
    img[1, :3] = 0
    img = img[..., 0] if channels == 1 else img
    filters = [FILTERS[filt]] * h if FILTERS[filt] is not None \
        else list(rs.randint(0, 5, h))
    data = _png(img, filters)
    np.testing.assert_array_equal(imageio.decode_png(data), img)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if channels == 2:           # cv2 gives gray + alpha as BGRA
        assert want.shape == (h, w, 4)
        np.testing.assert_array_equal(want[..., 0], img[..., 0])
    else:
        np.testing.assert_array_equal(_cv2_order(imageio.decode_png(data)), want)
    np.testing.assert_array_equal(imageio.decode_image(path), jax_decode(path))


TIFF_COMPRESSION = {"none": 1, "lzw": 5, "deflate": 8, "packbits": 32773}


@pytest.mark.unit
@pytest.mark.parametrize("rows_per_strip", [None, 7], ids=["one-strip", "strips"])
@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["8bit", "16bit"])
@pytest.mark.parametrize("compression", list(TIFF_COMPRESSION))
def test_cv2_tiff_decodes_like_cv2(compression, dtype, channels,
                                   rows_per_strip, tmp_path):
    rs = np.random.RandomState(channels + TIFF_COMPRESSION[compression])
    top = np.iinfo(dtype).max
    img = (rs.rand(37, 53, channels) * (top + 1)).astype(dtype)
    img[5:20, 10:40] = img[5, 10]           # runs, for LZW and PackBits
    img = img[..., 0] if channels == 1 else img
    params = [cv2.IMWRITE_TIFF_COMPRESSION, TIFF_COMPRESSION[compression]]
    if rows_per_strip:
        params += [cv2.IMWRITE_TIFF_ROWSPERSTRIP, rows_per_strip]
    path = tmp_path / "x.tif"
    assert cv2.imwrite(str(path), img, params)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    got = imageio.decode_tiff(path.read_bytes())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(_cv2_order(got), want)
    np.testing.assert_array_equal(imageio.decode_image(path), jax_decode(path))


@pytest.mark.unit
def test_float_tiff_clips_like_jax(tmp_path):
    img = (np.random.RandomState(4).randn(16, 24) * 40000).astype(np.float32)
    path = tmp_path / "f.tif"
    assert cv2.imwrite(str(path), img, [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    np.testing.assert_array_equal(imageio.decode_tiff(path.read_bytes()),
                                  cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(imageio.decode_image(path), jax_decode(path))


@pytest.mark.unit
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["8bit", "16bit"])
def test_rgb_to_gray_rounds_like_cv2(dtype):
    top = np.iinfo(dtype).max
    rgb = (np.random.RandomState(5).rand(64, 65, 3) * (top + 1)).astype(dtype)
    rgb[0, :4] = [[top, top, top], [top, 0, 0], [0, top, 0], [0, 0, top]]
    want = cv2.cvtColor(np.ascontiguousarray(rgb[..., ::-1]), cv2.COLOR_BGR2GRAY)
    np.testing.assert_array_equal(imageio.to_gray(rgb), want)


@pytest.mark.unit
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["8bit", "16bit"])
@pytest.mark.parametrize("shape", [(1, 1), (17, 5), (64, 64, 1)])
def test_encode_png_reads_back_in_cv2(dtype, shape, tmp_path):
    top = np.iinfo(dtype).max
    img = (np.random.RandomState(6).rand(*shape) * (top + 1)).astype(dtype)
    path = tmp_path / "e.png"
    path.write_bytes(imageio.encode_png(img))
    flat = img.reshape(shape[:2])
    np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), flat)
    np.testing.assert_array_equal(imageio.decode_png(path.read_bytes()), flat)
    with pytest.raises(ValueError):
        imageio.encode_png(img.astype(np.float32))


def _unported(fn, *args, match="Dataset decoding, the rest"):
    with pytest.raises(NotImplementedError, match=match):
        fn(*args)


@pytest.mark.unit
def test_unported_formats_raise(tmp_path):
    """What the port still does not read raises NotImplementedError naming
    the Queue 1 item (and the TIFF tag's value): an arithmetic-coded JPEG
    and a TIFF compression it lacks; Adam7, palette PNGs and JPEG now
    decode (tests/test_torch_imageio_rest.py). Corrupt files raise
    ValueError or OSError."""
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    path = tmp_path / "x.jpg"
    assert cv2.imwrite(str(path), img)
    data = bytearray(path.read_bytes())
    at = data.find(b"\xff\xc0")
    data[at + 1] = 0xC9                          # SOF9: arithmetic coding
    path.write_bytes(bytes(data))
    _unported(imageio.decode_image, path)
    tif = tmp_path / "x.tif"
    assert cv2.imwrite(str(tif), img, [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    data = bytearray(tif.read_bytes())
    ifd, = struct.unpack("<I", data[4:8])       # cv2 writes little-endian
    n, = struct.unpack("<H", data[ifd:ifd + 2])
    for i in range(n):
        at = ifd + 2 + 12 * i
        if struct.unpack("<H", data[at:at + 2])[0] == 259:
            data[at + 8:at + 10] = struct.pack("<H", 3)
    _unported(imageio.decode_tiff, bytes(data), match="compression 3 .CCITT T.4.")
    good = _png(img, [1] * 3)
    with pytest.raises(ValueError, match="CRC"):
        imageio.decode_png(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    with pytest.raises(ValueError):
        imageio.decode_png(good[:8] + good[33:])       # no IHDR
    junk = tmp_path / "junk.png"
    junk.write_bytes(b"not an image")
    with pytest.raises(OSError):
        imageio.decode_image(junk)


@pytest.mark.unit
def test_load_images_matches_jax(tmp_path):
    """A corpus of PNGs (cv2-written, 8- and 16-bit) and TIFFs: the split's
    (N, H, W, 1) uint16 frames and labels equal JAX's bulk decode."""
    rs = np.random.RandomState(8)
    for cls in ("normal", "cancerous"):
        (tmp_path / cls).mkdir()
        for i in range(3):
            img = (rs.rand(20, 24) * 65535).astype(np.uint16)
            cv2.imwrite(str(tmp_path / cls / f"{cls}_{i}.png"),
                        img if i else (img >> 8).astype(np.uint8))
        cv2.imwrite(str(tmp_path / cls / f"{cls}_9.tif"),
                    (rs.rand(20, 24, 3) * 255).astype(np.uint8))
    split = tmp_path / "split.json"
    split.write_text('{"train": [0, 3, 5, 7], "val": [1], "test": [2, 6]}')
    cfg = {"data_path": str(tmp_path), "split_file": str(split)}
    got, want = CARSThyroidDataset(cfg, split="all"), JaxDataset(cfg, split="all")
    frames = got.load_images(num_threads=3)
    assert frames.shape == (8, 20, 24, 1) and frames.dtype == np.uint16
    np.testing.assert_array_equal(frames, want.load_images())
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.class_distribution() == want.class_distribution() == \
        {"normal": 4, "cancerous": 4}
    train = CARSThyroidDataset(cfg, split="train")
    jtrain = JaxDataset(cfg, split="train")
    np.testing.assert_array_equal(train.indices, jtrain.indices)
    img, label = train[0]
    np.testing.assert_array_equal(img, jtrain[0][0])
    assert label == jtrain[0][1]
