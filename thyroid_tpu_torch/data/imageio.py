"""PNG and TIFF decoding, and a PNG writer, on zlib and numpy.

The JAX package decodes through cv2 (then PIL, then imageio) and a libpng
batch decoder (thyroid_tpu/native); none of them is on the card's machine,
so the port reads the formats itself, pixel-equal to cv2's
`imread(IMREAD_UNCHANGED)` (`tests/test_torch_imageio.py`):

- PNG: grayscale, gray + alpha, RGB and RGBA at 8 and 16 bits, all five
  row filters. Rows with the None and Sub filters (Sub is a cumulative
  sum per byte lane modulo 256) and runs of Up rows (a cumulative sum down
  the rows) are whole-array operations; when Average or Paeth rows are
  present, whose bytes each depend on the decoded byte to their left, the
  image is decoded along anti-diagonals, every row at once, in H + W - 1
  steps. Adam7 interlacing, palettes and depths below 8 raise
  NotImplementedError.
- TIFF: the first image of the file, in strips, chunky samples of 8 or 16
  bits (unsigned) or 32-bit float, uncompressed, LZW, Deflate or
  PackBits, with or without horizontal differencing (cv2 writes LZW with
  it by default). Other compressions raise NotImplementedError naming the
  tag's value.
- JPEG raises NotImplementedError.

Arrays come back as (H, W) or (H, W, C) with the channels in file order
(R, G, B[, A]); cv2 gives them as B, G, R[, A].
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# cv2's RGB → gray weights (COLOR_BGR2GRAY on 8 and 16 bits): integers of
# sum 2^15, rounded to nearest
_GRAY_SHIFT = 15
_GRAY_R, _GRAY_G, _GRAY_B = 9798, 19235, 3735
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported (ROADMAP Queue 1: Dataset decoding, the rest)")


# ---------------------------------------------------------------- PNG ----
def _png_chunks(data: bytes):
    """(type, payload) of each chunk after the signature, CRCs checked,
    up to IEND."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc_at = pos + 8 + length
        if len(body) != length or crc_at + 4 > len(data):
            raise ValueError("truncated PNG chunk")
        crc, = struct.unpack(">I", data[crc_at:crc_at + 4])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos = crc_at + 4
    raise ValueError("PNG file has no IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_wavefront(ftype: np.ndarray, filt: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Any mix of the five filters: pixel (r, x) needs (r, x-1), (r-1, x)
    and (r-1, x-1), so step t decodes every pixel with r + x = t."""
    h, stride = filt.shape
    w = stride // bpp
    f = filt.reshape(h, w, bpp).astype(np.int16)
    # decoded bytes, with a zero row above and a zero column on the left
    rec = np.zeros((h + 1, w + 1, bpp), np.int16)
    for t in range(h + w - 1):
        r = np.arange(max(0, t - w + 1), min(h - 1, t) + 1)
        x = t - r
        a, b, c = rec[r + 1, x], rec[r, x + 1], rec[r, x]
        kind = ftype[r][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[r + 1, x + 1] = (f[r, x] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8).reshape(h, stride)


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + stride) filtered scanlines → (H, stride) bytes."""
    ftype, filt = raw[:, 0], raw[:, 1:]
    if ftype.size and ftype.max() > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} is not defined")
    if np.any(ftype >= 3):
        return _unfilter_wavefront(ftype, filt, bpp)
    out = filt.copy()
    sub = ftype == 1
    if sub.any():
        rows = out[sub].reshape(int(sub.sum()), -1, bpp)
        out[sub] = np.cumsum(rows, axis=1, dtype=np.uint8).reshape(rows.shape[0], -1)
    up = np.flatnonzero(ftype == 2)
    if up.size:
        starts = up[np.r_[True, np.diff(up) > 1]]
        ends = up[np.r_[np.diff(up) > 1, True]] + 1
        for s, e in zip(starts, ends):
            above = out[s - 1:s] if s > 0 else np.zeros_like(out[:1])
            out[s:e] = np.cumsum(np.concatenate([above, out[s:e]]), axis=0,
                                 dtype=np.uint8)[1:]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W) or (H, W, C) uint8/uint16, channels in file
    order."""
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            raise _unported("PNG with a palette")
        elif kind[0:1].isupper() and kind not in (b"IEND",):
            raise ValueError(f"unknown critical PNG chunk {kind!r}")
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if interlace:
        raise _unported("Adam7-interlaced PNG")
    if color == 3:
        raise _unported("PNG with a palette")
    if color not in _PNG_CHANNELS or compression or filter_method:
        raise ValueError(f"bad PNG header {header}")
    if depth not in (8, 16):
        raise _unported(f"PNG at {depth} bits a sample")
    channels = _PNG_CHANNELS[color]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, count=height * (stride + 1))
    pix = _unfilter(rows.reshape(height, stride + 1), bpp)
    if depth == 16:
        pix = pix.view(">u2").astype(np.uint16)
    img = pix.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) (or (H, W, 1)) uint8 or uint16 grayscale → PNG bytes, every
    row with the Sub filter, zlib at level 1 (cv2's default, its fastest)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"encode_png takes (H, W) uint8 or uint16 gray, "
                         f"got {img.dtype} {img.shape}")
    height, width = img.shape
    depth = 8 * img.dtype.itemsize
    bpp = img.dtype.itemsize
    pix = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))) \
        .view(np.uint8).reshape(height, width * bpp)
    filt = np.empty((height, width * bpp + 1), np.uint8)
    filt[:, 0] = 1
    filt[:, 1:1 + bpp] = pix[:, :bpp]
    filt[:, 1 + bpp:] = pix[:, bpp:] - pix[:, :-bpp]
    header = struct.pack(">IIBBBBB", width, height, depth, 0, 0, 0, 0)
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(filt.tobytes(), 1))
            + _png_chunk(b"IEND", b""))


# --------------------------------------------------------------- TIFF ----
_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B",
               8: "h", 9: "i", 10: "ii", 11: "f", 12: "d"}
_TIFF_COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT T.4",
                      4: "CCITT T.6", 5: "LZW", 6: "old-style JPEG",
                      7: "JPEG", 8: "Deflate", 32773: "PackBits",
                      32946: "Deflate", 34712: "JPEG 2000", 34925: "LZMA",
                      50000: "Zstandard", 50001: "WebP"}


def _tiff_tags(data: bytes, order: str, offset: int) -> dict:
    """{tag: tuple of values} of the IFD at `offset`."""
    n, = struct.unpack(order + "H", data[offset:offset + 2])
    tags = {}
    for i in range(n):
        at = offset + 2 + 12 * i
        tag, kind, count = struct.unpack(order + "HHI", data[at:at + 8])
        fmt = _TIFF_TYPES.get(kind)
        if fmt is None:
            continue
        size = struct.calcsize(order + fmt) * count
        if size <= 4:
            where = at + 8
        else:
            where, = struct.unpack(order + "I", data[at + 8:at + 12])
        tags[tag] = struct.unpack(order + fmt * count,
                                  data[where:where + size])
    return tags


def _lzw_decode(data: bytes) -> bytes:
    """TIFF LZW: codes of 9-12 bits, most significant bit first, the
    width growing one code early; 256 clears the table, 257 ends."""
    if data[:2] == b"\x00\x01":
        raise _unported("TIFF with old-style (LSB-first) LZW")
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
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError("corrupt LZW data")
            if len(table) + 1 >= (1 << nbits) and nbits < 12:
                nbits += 1
        out += entry
        prev = entry
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    pos, size = 0, len(data)
    while pos < size:
        n = data[pos] - 256 if data[pos] > 127 else data[pos]
        pos += 1
        if n >= 0:
            out += data[pos:pos + n + 1]
            pos += n + 1
        elif n != -128:
            out += data[pos:pos + 1] * (1 - n)
            pos += 1
    return bytes(out)


def decode_tiff(data: bytes) -> np.ndarray:
    """The first image of a TIFF → (H, W) or (H, W, C), uint8, uint16 or
    float32, channels in file order."""
    if data[:4] == b"II*\x00":
        order = "<"
    elif data[:4] == b"MM\x00*":
        order = ">"
    elif data[:4] in (b"II+\x00", b"MM\x00+"):
        raise _unported("BigTIFF")
    else:
        raise ValueError("not a TIFF file")
    offset, = struct.unpack(order + "I", data[4:8])
    tags = _tiff_tags(data, order, offset)
    width, height = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    bits = set(tags.get(258, (1,)))
    compression = tags.get(259, (1,))[0]
    photometric = tags.get(262, (1,))[0]
    predictor = tags.get(317, (1,))[0]
    sample_format = tags.get(339, (1,))[0]
    if 322 in tags:
        raise _unported("tiled TIFF")
    if tags.get(284, (1,))[0] != 1:
        raise _unported("TIFF with planar sample layout")
    if tags.get(266, (1,))[0] != 1:
        raise _unported("TIFF with fill order 2")
    if compression not in (1, 5, 8, 32773, 32946):
        raise _unported(f"TIFF compression {compression} "
                        f"({_TIFF_COMPRESSIONS.get(compression, 'unknown')})")
    if photometric not in (1, 2):
        raise _unported(f"TIFF photometric interpretation {photometric}")
    if len(bits) != 1:
        raise _unported(f"TIFF with mixed sample depths {sorted(bits)}")
    depth = bits.pop()
    dtypes = {(8, 1): "u1", (16, 1): "u2", (32, 3): "f4"}
    if (depth, sample_format) not in dtypes:
        raise _unported(f"TIFF with {depth}-bit samples of format "
                        f"{sample_format}")
    if predictor not in (1, 2) or (predictor == 2 and sample_format == 3):
        raise _unported(f"TIFF predictor {predictor}")
    dtype = np.dtype(order + dtypes[(depth, sample_format)])
    strips = []
    for at, count in zip(tags[273], tags[279]):
        chunk = data[at:at + count]
        if compression == 5:
            chunk = _lzw_decode(chunk)
        elif compression in (8, 32946):
            chunk = zlib.decompress(chunk)
        elif compression == 32773:
            chunk = _packbits_decode(chunk)
        strips.append(chunk)
    rows_per_strip = min(tags.get(278, (height,))[0], height)
    row_bytes = width * spp * dtype.itemsize
    pieces = [s[:min(rows_per_strip, height - i * rows_per_strip) * row_bytes]
              for i, s in enumerate(strips)]
    buf = b"".join(pieces)
    if len(buf) < height * row_bytes:
        raise ValueError("TIFF image data is truncated")
    native = dtype.newbyteorder("=")
    img = np.frombuffer(buf, dtype, count=height * width * spp) \
        .reshape(height, width, spp).astype(native)
    if predictor == 2:
        # horizontal differencing: a running sum along each row and sample,
        # wrapping like the samples' own type
        img = np.cumsum(img, axis=1, dtype=native)
    return img[..., 0] if spp == 1 else img


# ---------------------------------------------------------- one image ----
def to_gray(img: np.ndarray) -> np.ndarray:
    """(H, W, C) in file order → (H, W): gray + alpha keeps the gray;
    RGB(A) of 8 or 16 bits takes cv2's COLOR_BGR2GRAY weights and
    rounding."""
    if img.shape[-1] == 2:
        return img[..., 0]
    if img.dtype.kind == "f":
        # cv2's float conversion fuses multiply-adds in an order of its own
        raise _unported("color image of float samples")
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    acc = (b.astype(np.int64) * _GRAY_B + g.astype(np.int64) * _GRAY_G
           + r.astype(np.int64) * _GRAY_R + (1 << (_GRAY_SHIFT - 1)))
    return (acc >> _GRAY_SHIFT).astype(img.dtype)


def decode_file(path: str | Path) -> np.ndarray:
    """A PNG or TIFF file → its array (decode_png / decode_tiff)."""
    data = Path(path).read_bytes()
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data)
    if data[:2] in (b"II", b"MM"):
        return decode_tiff(data)
    if data[:3] == b"\xff\xd8\xff":
        raise _unported(f"JPEG ({path})")
    raise OSError(f"could not decode image {path}: neither PNG nor TIFF")


def decode_image(path: str | Path) -> np.ndarray:
    """One image → (H, W) uint16, as the JAX package's decode_image gives
    it: color to gray, uint8 × 257, other types clipped to [0, 65535]."""
    img = decode_file(path)
    if img.ndim == 3:
        img = to_gray(img)
    if img.dtype == np.uint8:
        return img.astype(np.uint16) * 257
    if img.dtype != np.uint16:
        return np.clip(img.astype(np.float64), 0, 65535).astype(np.uint16)
    return img
