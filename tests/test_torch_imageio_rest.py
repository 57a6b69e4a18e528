"""The rest of the port's decoding (thyroid_tpu_torch.data.imageio) against
cv2 and the JAX package's decode_image, on the CPU, pixel-equal: LZW
decoded segment by segment without a loop per code (new-style and
old-style, against the loop decoder it replaced), TIFF tiles, planar
samples, fill order 2, BigTIFF and JPEG-in-TIFF, PNG Adam7, palettes,
depths below 8 and RGB transparency keys, colour images of float samples, and JPEG (baseline and
progressive, gray and YCbCr at every sampling cv2 writes, restart
intervals). Layouts cv2 cannot write come from tests/imageio_writers.py
and are read by cv2 for the reference; all frames are at most 64² but one
512² LZW frame."""
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from tests import imageio_writers as writers
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu.data.dataset import CARSThyroidDataset as JaxDataset
from thyroid_tpu.data.dataset import decode_image as jax_decode
from thyroid_tpu_torch.data import imageio
from thyroid_tpu_torch.data.dataset import CARSThyroidDataset

RS = np.random.RandomState(22)
G8 = (RS.rand(37, 45) * 256).astype(np.uint8)
G8[5:20, 5:30] = 7                       # runs, for LZW and PackBits
C8 = (RS.rand(37, 45, 3) * 256).astype(np.uint8)
C16 = (RS.rand(37, 45, 3) * 65536).astype(np.uint16)
PALETTE = (RS.rand(16, 3) * 256).astype(np.uint8)


def _cv2_order(img):
    if img.ndim == 2:
        return img
    return img[..., [2, 1, 0] + ([3] if img.shape[-1] == 4 else [])]


def _same_as_cv2(data: bytes, tmp_path, suffix: str, decode):
    """decode(data) equals cv2's imread of the file, and the port's
    decode_image equals JAX's."""
    path = tmp_path / f"x{suffix}"
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert want is not None
    got = decode(data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(_cv2_order(got), want)
    np.testing.assert_array_equal(imageio.decode_image(path), jax_decode(path))
    return got


def _lzw_loop(data: bytes) -> bytes:
    """The loop decoder the segment decoder replaced (one Python step per
    code), kept as its reference."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    nbits, prev = 9, None
    bitbuf, nbuf, pos, size = 0, 0, 0, len(data)
    while True:
        while nbuf < nbits and pos < size:
            bitbuf = ((bitbuf << 8) | data[pos]) & 0xFFFFFF
            nbuf += 8
            pos += 1
        if nbuf < nbits:
            break
        nbuf -= nbits
        code = (bitbuf >> nbuf) & ((1 << nbits) - 1)
        if code == 257:
            break
        if code == 256:
            del table[258:]
            nbits, prev = 9, None
            continue
        if prev is None:
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            if len(table) + 1 >= (1 << nbits) and nbits < 12:
                nbits += 1
        out += entry
        prev = entry
    return bytes(out)


@pytest.mark.unit
@pytest.mark.parametrize("case", ["runs", "noise", "kwkwk", "truncated",
                                  "no-clears"])
def test_lzw_segments_equal_the_loop_decoder(case):
    """Segment decoding gives the loop decoder's bytes: long strings,
    incompressible data (12-bit codes and table-full clears), the KwKwK
    code, a stream cut short (no end code) and a stream that clears only
    when its table is full."""
    rs = np.random.RandomState(3)
    data = {"runs": bytes(np.repeat(rs.randint(0, 4, 400), 30).astype(np.uint8)),
            "noise": rs.randint(0, 256, 9000).astype(np.uint8).tobytes(),
            "kwkwk": b"a" * 5000 + b"ab" * 700,
            "truncated": bytes(np.repeat(rs.randint(0, 9, 300), 5).astype(np.uint8)),
            "no-clears": rs.randint(0, 3, 30000).astype(np.uint8).tobytes()}[case]
    stream = writers.lzw_encode(data, clear_every=0 if case == "no-clears" else 500)
    if case == "truncated":
        stream = stream[:len(stream) * 2 // 3]
    got = imageio._lzw_decode(stream)
    assert got == _lzw_loop(stream)
    if case != "truncated":
        assert got == data


@pytest.mark.unit
def test_lzw_512_frame_like_cv2(tmp_path):
    """One 512² uint16 frame that cv2 writes with LZW (and horizontal
    differencing)."""
    y, x = np.mgrid[0:512, 0:512]
    frame = (32768 + 20000 * np.sin(x / 40.0) * np.cos(y / 57.0)
             + 5000 * np.cos((x - 2 * y) / 90.0)).astype(np.uint16)
    path = tmp_path / "lzw.tif"
    assert cv2.imwrite(str(path), frame, [cv2.IMWRITE_TIFF_COMPRESSION, 5])
    got = imageio.decode_tiff(path.read_bytes())
    np.testing.assert_array_equal(got, cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(got, frame)


TIFFS = {
    "tiles-gray8": lambda: writers.tiff(G8, tile=(16, 16)),
    "tiles-rgb16-lzw": lambda: writers.tiff(C16, tile=(16, 32), compression=5,
                                            predictor=2),
    "tiles-bigtiff-deflate": lambda: writers.tiff(C16, big=True, tile=(16, 16),
                                                  compression=8),
    "planar-rgb8": lambda: writers.tiff(C8, planar=True, rows_per_strip=10),
    "planar-rgb8-lzw": lambda: writers.tiff(C8, planar=True, compression=5,
                                            rows_per_strip=9),
    "fill2-none": lambda: writers.tiff(G8, fill_order=2),
    "fill2-lzw": lambda: writers.tiff(G8, fill_order=2, compression=5),
    "fill2-deflate": lambda: writers.tiff(G8, fill_order=2, compression=8),
    "fill2-packbits": lambda: writers.tiff(G8, fill_order=2, compression=32773),
    "bigtiff-le": lambda: writers.tiff(C16, big=True, rows_per_strip=8),
    "bigtiff-be-lzw": lambda: writers.tiff(G8, big=True, order=">", compression=5),
    "old-lzw-gray8": lambda: writers.tiff(G8, compression=5, old_lzw=True),
    "old-lzw-rgb16": lambda: writers.tiff(C16, compression=5, old_lzw=True,
                                          predictor=2),
}


@pytest.mark.unit
@pytest.mark.parametrize("name", sorted(TIFFS))
def test_tiff_layouts_like_cv2(name, tmp_path):
    _same_as_cv2(TIFFS[name](), tmp_path, ".tif", imageio.decode_tiff)


@pytest.mark.unit
@pytest.mark.parametrize("img", ["gray", "rgb"])
def test_jpeg_in_tiff_like_cv2(img, tmp_path):
    """Compression 7 as cv2 (libtiff) writes it: one JPEG a strip, its
    tables in the JPEGTables tag; YCbCr for colour."""
    path = tmp_path / "j.tif"
    assert cv2.imwrite(str(path), G8 if img == "gray" else C8,
                       [cv2.IMWRITE_TIFF_COMPRESSION, 7])
    _same_as_cv2(path.read_bytes(), tmp_path, ".tif", imageio.decode_tiff)


PNGS = {}
for _d in (1, 2, 4):
    _v = (RS.rand(13, 19) * (1 << _d)).astype(np.uint8)
    PNGS[f"gray{_d}"] = writers.png(_v, depth=_d)
    PNGS[f"gray{_d}-adam7"] = writers.png(_v, depth=_d, interlace=True)
    PNGS[f"palette{_d}"] = writers.png(_v, depth=_d, color=3,
                                       palette=PALETTE[:1 << _d])
    PNGS[f"palette{_d}-trns"] = writers.png(_v, depth=_d, color=3,
                                            palette=PALETTE[:1 << _d], trns=[0, 128])
_v = (RS.rand(29, 31) * 16).astype(np.uint8)
PNGS["palette8"] = writers.png(_v, color=3, palette=PALETTE)
PNGS["palette8-trns-adam7"] = writers.png(_v, color=3, palette=PALETTE,
                                          trns=[10, 20, 30], interlace=True)
PNGS["gray8-adam7"] = writers.png(G8, interlace=True)
PNGS["rgba16-adam7"] = writers.png((RS.rand(29, 31, 4) * 65536).astype(np.uint16),
                                   depth=16, color=6, interlace=True, filt=2)
PNGS["gray8-adam7-3x2"] = writers.png(G8[:3, :2], interlace=True)
_q = (RS.rand(13, 19) * 4).astype(np.uint8) * 60
PNGS["rgb8-trns"] = writers.png(np.stack([_q, _q // 2, _q // 3], -1), color=2,
                                trns=[0, 60, 0, 30, 0, 20])
PNGS["rgb16-trns"] = writers.png(np.stack([_q, _q // 2, _q // 3], -1).astype(np.uint16)
                                 * 257, depth=16, color=2,
                                 trns=[60, 60, 30, 30, 20, 20])
PNGS["gray8-trns"] = writers.png(_q, trns=[0, 60])


@pytest.mark.unit
@pytest.mark.parametrize("name", sorted(PNGS))
def test_png_variants_like_cv2(name, tmp_path):
    _same_as_cv2(PNGS[name], tmp_path, ".png", imageio.decode_png)


@pytest.mark.unit
@pytest.mark.parametrize("width", [45, 12, 64])
def test_float_color_to_gray_like_cv2(width, tmp_path):
    """cv2's float BGR2GRAY, bit for bit (its vector formula and the two
    pixels of a row's tail that take the other order), and a float RGB
    TIFF through decode_image as JAX decodes it."""
    rgb = (RS.randn(37, width, 3) * 30000).astype(np.float32)
    want = cv2.cvtColor(np.ascontiguousarray(rgb[..., ::-1]), cv2.COLOR_BGR2GRAY)
    np.testing.assert_array_equal(imageio.to_gray(rgb), want)
    path = tmp_path / "f.tif"
    assert cv2.imwrite(str(path), np.ascontiguousarray(np.abs(rgb[..., ::-1])),
                       [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    np.testing.assert_array_equal(imageio.decode_image(path), jax_decode(path))


def _smooth(h, w, channels):
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 90 * np.sin(x / 7.0) * np.cos(y / 9.0) + RS.randn(h, w) * 12
    img = np.stack([base, np.roll(base, 5, 1), 255 - base], -1)[..., :channels]
    return np.clip(img, 0, 255).astype(np.uint8).squeeze()


SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


@pytest.mark.unit
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("kind", ["gray", "gray-restart"] + sorted(SAMPLINGS)
                         + ["420-restart"])
def test_jpeg_like_cv2(kind, progressive, tmp_path):
    """Huffman-coded 8-bit JPEGs as cv2 writes them: the islow IDCT, fancy
    upsampling (h2v1, h2v2, h1v2; replication at 4:1:1) and the YCbCr
    tables give cv2's pixels exactly, with and without restart markers."""
    gray = kind.startswith("gray")
    img = _smooth(45, 61, 1 if gray else 3)
    params = [cv2.IMWRITE_JPEG_QUALITY, 85,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    if not gray:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[kind[:3]]]
    if kind.endswith("restart"):
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    got = _same_as_cv2(buf.tobytes(), tmp_path, ".jpg", imageio.decode_jpeg)
    assert got.shape == img.shape


def _jpeg_with(data: bytes, marker: int, precision=None) -> bytes:
    """The stream with its frame marker replaced (and its precision)."""
    for sof in (0xC0, 0xC1, 0xC2):
        at = data.find(bytes([0xFF, sof]))
        if at > 0:
            out = bytearray(data)
            out[at + 1] = marker
            if precision is not None:
                out[at + 4] = precision
            return bytes(out)
    raise AssertionError("no frame marker")


@pytest.mark.unit
def test_unported_jpeg_and_tiff_raise(tmp_path):
    """Arithmetic coding, lossless, 12-bit and four-component JPEGs, planar
    TIFFs of 16-bit samples (which cv2 here misreads) and other TIFF
    compressions raise NotImplementedError naming what they are and the
    Queue 1 item."""
    ok, buf = cv2.imencode(".jpg", _smooth(16, 16, 1))
    data = buf.tobytes()
    for marker, what in ((0xC9, "arithmetic-coded JPEG"),
                         (0xCA, "arithmetic-coded progressive JPEG"),
                         (0xC3, "lossless JPEG")):
        with pytest.raises(NotImplementedError, match=what):
            imageio.decode_jpeg(_jpeg_with(data, marker))
    with pytest.raises(NotImplementedError, match="12-bit JPEG"):
        imageio.decode_jpeg(_jpeg_with(data, 0xC1, precision=12))
    at = data.find(b"\xff\xc0")
    four = bytearray(data[:at + 9]) + b"\x04" + data[at + 10:]
    with pytest.raises(NotImplementedError, match="four-component"):
        imageio.decode_jpeg(bytes(four))
    with pytest.raises(NotImplementedError, match="planar TIFF of 16-bit"):
        imageio.decode_tiff(writers.tiff(C16, planar=True))
    tif = writers.tiff(G8)
    at = tif.find(struct.pack("<HHI", 259, 3, 1))
    lzma = tif[:at + 8] + struct.pack("<H", 34925) + tif[at + 10:]
    with pytest.raises(NotImplementedError, match=r"compression 34925 \(LZMA\).*"
                       "Dataset decoding, the rest"):
        imageio.decode_tiff(lzma)


@pytest.mark.unit
def test_load_images_reads_every_format_like_jax(tmp_path):
    """A corpus of JPEGs (gray, progressive colour), a palette PNG, an
    Adam7 PNG and tiled and BigTIFF TIFFs: the (N, H, W, 1) uint16 frames
    load_images gives (the k-fold experiment's path) equal JAX's."""
    for cls, seed in (("normal", 0), ("cancerous", 1)):
        d = tmp_path / cls
        d.mkdir()
        img = _smooth(20, 24, 3)
        cv2.imwrite(str(d / f"{cls}_0.jpg"), img[..., 0])
        cv2.imwrite(str(d / f"{cls}_1.jpeg"), img,
                    [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        (d / f"{cls}_2.png").write_bytes(writers.png(
            (img[..., 0] >> 4).astype(np.uint8), color=3, palette=PALETTE))
        (d / f"{cls}_3.png").write_bytes(writers.png(img, color=2, interlace=True))
        (d / f"{cls}_4.tif").write_bytes(writers.tiff(img[..., 1], tile=(16, 16)))
        (d / f"{cls}_5.tiff").write_bytes(writers.tiff(
            (img.astype(np.uint16) * 200 + seed), big=True, compression=5))
    cfg = {"data_path": str(tmp_path)}
    got, want = CARSThyroidDataset(cfg, split="all"), JaxDataset(cfg, split="all")
    frames = got.load_images(num_threads=2)
    assert frames.shape == (12, 20, 24, 1) and frames.dtype == np.uint16
    np.testing.assert_array_equal(frames, want.load_images())
    np.testing.assert_array_equal(got.labels, want.labels)


FIXTURES = Path(__file__).resolve().parent / "fixtures" / "imageio"


@pytest.mark.unit
@pytest.mark.parametrize("name", sorted(json.loads(
    (FIXTURES / "hashes.json").read_text())))
def test_committed_fixtures_match_their_hashes(name):
    """Each committed fixture (chip_smoke.py phase 23 decodes them on the
    card's host) gives the SHA-256 of cv2's array stored beside it, and of
    JAX's decode_image."""
    from tests.fixtures.imageio.make_fixtures import array_digest

    want = json.loads((FIXTURES / "hashes.json").read_text())[name]
    got = imageio.decode_file(FIXTURES / name)
    assert array_digest(_cv2_order(got)) == want["cv2"]
    assert array_digest(imageio.decode_image(FIXTURES / name)) == want["decode_image"]
