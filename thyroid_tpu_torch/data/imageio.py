"""PNG, TIFF and JPEG decoding, and a PNG writer, on zlib and numpy.

The JAX package decodes through cv2 (then PIL, then imageio) and a libpng
batch decoder (thyroid_tpu/native); none of them is on the card's machine,
so the port reads the formats itself, pixel-equal to cv2's
`imread(IMREAD_UNCHANGED)` (`tests/test_torch_imageio.py`,
`tests/test_torch_imageio_rest.py`):

- PNG: every colour type and depth: gray at 1, 2, 4, 8 and 16 bits (below
  8 scaled to 8 as libpng expands them for cv2), gray + alpha, RGB and
  RGBA at 8 and 16 (RGB with a tRNS colour key gains alpha), palettes at
  1-8 bits (RGB, or RGBA with a tRNS chunk), Adam7 interlacing, all five
  row filters. Rows with the None
  and Sub filters (Sub is a cumulative sum per byte lane modulo 256) and
  runs of Up rows (a cumulative sum down the rows) are whole-array
  operations; when Average or Paeth rows are present, whose bytes each
  depend on the decoded byte to their left, the image is decoded along
  anti-diagonals, every row at once, in H + W - 1 steps.
- TIFF and BigTIFF: the first image of the file, in strips or tiles,
  chunky or planar samples (planar at 8 bits: cv2 here misreads planar
  16-bit files, which raise), fill order 1 or 2, samples of 8 or 16 bits
  (unsigned) or 32-bit float, uncompressed, LZW (new-style, and old-style
  LSB-first), Deflate, PackBits or JPEG (compression 7, through
  decode_jpeg with the JPEGTables tag), with or without horizontal
  differencing. LZW decodes a segment between clear codes at a time with
  whole-array steps (`_lzw_strings`), no Python loop per code. Other
  compressions raise NotImplementedError naming the tag's value.
- JPEG: Huffman-coded, 8-bit, baseline, extended and progressive, gray
  or YCbCr (RGB by the Adobe marker) at any integral sampling, restart
  intervals; libjpeg-turbo's islow IDCT, fancy upsampling and YCbCr
  tables. Arithmetic coding, lossless, hierarchical, 12-bit and
  four-component JPEGs, and progressive scans that leave coefficients
  incomplete (which libjpeg smooths), raise NotImplementedError.
- colour images of float samples take cv2's float BGR2GRAY (`to_gray`).

Arrays come back as (H, W) or (H, W, C) with the channels in file order
(R, G, B[, A]); cv2 gives them as B, G, R[, A].
"""
from __future__ import annotations

import functools
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


# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
               6: (8, 16)}


def _png_samples(raw: np.ndarray, at: int, w: int, h: int, channels: int,
                 depth: int):
    """One (sub)image of w x h at byte `at` of the inflated stream →
    (samples (h, w, channels), bytes used); an empty pass takes none."""
    if w == 0 or h == 0:
        return np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8), 0
    stride = -(-w * channels * depth // 8)
    used = h * (stride + 1)
    if raw.size < at + used:
        raise ValueError("PNG image data is truncated")
    pix = _unfilter(raw[at:at + used].reshape(h, stride + 1),
                    max(1, channels * depth // 8))
    if depth == 16:
        return pix.view(">u2").astype(np.uint16).reshape(h, w, channels), used
    if depth < 8:       # packed samples, most significant first
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        pix = ((pix[:, :, None] >> shifts) & ((1 << depth) - 1)) \
            .reshape(h, stride * per)[:, :w * channels]
    return pix.reshape(h, w, channels), used


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W) or (H, W, C) uint8/uint16, channels in file
    order: every colour type and depth, Adam7 interlacing, palettes (RGB,
    or RGBA where a tRNS chunk gives alpha), gray below 8 bits scaled to 8
    as libpng expands it for cv2."""
    header, idat, palette, trns = None, [], None, None
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind[0:1].isupper() and kind not in (b"IEND",):
            raise ValueError(f"unknown critical PNG chunk {kind!r}")
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if color not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[color] \
            or compression or filter_method or interlace > 1:
        raise ValueError(f"bad PNG header {header}")
    if color == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    channels = 1 if color == 3 else _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace:
        img = np.zeros((height, width, channels),
                       np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
            part, used = _png_samples(raw, at, max(w, 0), max(h, 0), channels, depth)
            img[y0::dy, x0::dx] = part
            at += used
    else:
        img, _ = _png_samples(raw, 0, width, height, channels, depth)
    if color == 3:
        index = img[..., 0]
        if index.max(initial=0) >= len(palette):
            raise ValueError("PNG palette index out of range")
        if trns is None:
            return palette[index]
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[:min(len(trns), len(palette))] = trns[:len(palette)]
        return np.concatenate([palette[index], alpha[index][..., None]], axis=-1)
    if depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if color == 2 and trns is not None and len(trns) >= 6:
        # libpng's tRNS-to-alpha for RGB: transparent where the pixel is
        # the chunk's colour (cv2 then gives 4 channels; gray stays gray)
        key = np.frombuffer(trns[:6].tobytes(), ">u2").astype(img.dtype)
        top = np.iinfo(img.dtype).max
        alpha = np.where((img == key).all(axis=-1), 0, top).astype(img.dtype)
        img = np.concatenate([img, alpha[..., None]], axis=-1)
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
               8: "h", 9: "i", 10: "ii", 11: "f", 12: "d", 13: "I",
               16: "Q", 17: "q", 18: "Q"}
_TIFF_COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT T.4",
                      4: "CCITT T.6", 5: "LZW", 6: "old-style JPEG",
                      7: "JPEG", 8: "Deflate", 32773: "PackBits",
                      32946: "Deflate", 34712: "JPEG 2000", 34925: "LZMA",
                      50000: "Zstandard", 50001: "WebP"}
_TIFF_READ = (1, 5, 7, 8, 32773, 32946)
# libtiff reverses the bits of fill-order-2 data before these codecs (its
# JPEG codec sets TIFF_NOBITREV)
_TIFF_BITREV = (1, 5, 8, 32773, 32946)
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _tiff_tags(data: bytes, order: str, offset: int, big: bool) -> dict:
    """{tag: tuple of values} of the IFD at `offset` (BigTIFF: 8-byte
    counts and offsets, 20-byte entries)."""
    head, entry, inline, ofmt = ("Q", 20, 8, "Q") if big else ("H", 12, 4, "I")
    n, = struct.unpack(order + head, data[offset:offset + struct.calcsize(head)])
    first = offset + struct.calcsize(head)
    tags = {}
    for i in range(n):
        at = first + entry * i
        cfmt = order + ("HHQ" if big else "HHI")
        tag, kind, count = struct.unpack(cfmt, data[at:at + struct.calcsize(cfmt)])
        fmt = _TIFF_TYPES.get(kind)
        if fmt is None:
            continue
        value_at = at + struct.calcsize(cfmt)
        size = struct.calcsize(order + fmt) * count
        if size <= inline:
            where = value_at
        else:
            where, = struct.unpack(order + ofmt, data[value_at:value_at + inline])
        tags[tag] = struct.unpack(order + fmt * count, data[where:where + size])
    return tags


# LZW: codes of 9-12 bits; 256 clears the string table, 257 ends. Between
# two clear codes the width of every code follows from its index j in the
# segment (the table grows by one entry a code after the first), so all of
# a segment's codes are read at once. New-style (libtiff's "one code
# early", most significant bit first) widens to 10 bits at j = 254, to 11
# at 766 and to 12 at 1790; old-style (LSB first, the stream starting with
# a clear code: bytes 00, then an odd byte) one code later.
_LZW_WIDEN = {False: (254, 766, 1790), True: (255, 767, 1791)}


def _lzw_codes(bits: np.ndarray, start: int, total: int, compat: bool,
               count: int):
    """(codes, bit offset after each) of up to `count` codes of a segment
    beginning at bit `start`; codes that would run past `total` bits are
    dropped, as the loop decoder stops there."""
    j = np.arange(count)
    widths = 9 + sum((j >= w).astype(np.int64) for w in _LZW_WIDEN[compat])
    ends = start + np.cumsum(widths)
    keep = ends <= total
    widths, ends = widths[keep], ends[keep]
    offs = ends - widths
    at = offs >> 3
    b = bits
    if compat:   # least significant bit first
        win = (b[at] | (b[at + 1] << 8) | (b[at + 2] << 16) | (b[at + 3] << 24))
        codes = (win >> (offs & 7)) & ((1 << widths) - 1)
    else:
        win = ((b[at] << 24) | (b[at + 1] << 16) | (b[at + 2] << 8) | b[at + 3])
        codes = (win >> (32 - widths - (offs & 7))) & ((1 << widths) - 1)
    return codes, ends


def _lzw_strings(codes: np.ndarray) -> np.ndarray:
    """The bytes of one segment's codes (no clear or end code among them).
    The string table is a tree: entry 258 + e, made by code e + 1, is the
    string of code e and one byte, the first byte of code e + 1's string.
    Lengths and first bytes follow by pointer doubling, and each output
    byte is an ancestor of its code's node, found by binary lifting: about
    log2(4096) array steps, no loop per code."""
    n = len(codes)
    if n == 0:
        return np.zeros(0, np.uint8)
    limit = 258 + np.arange(n) - 1          # code k may name entries < 257 + k
    if codes[0] > 255 or np.any(codes[1:] > limit[1:]) \
            or np.any((codes == 256) | (codes == 257)):
        raise ValueError("corrupt LZW data")
    size = 257 + n
    parent = np.arange(size)
    parent[258:] = codes[:-1]
    dist = np.zeros(size, np.int64)
    dist[258:] = 1
    root, ups = parent.copy(), [parent]
    while True:                              # list ranking: depth and root
        nxt = root[root]
        if np.array_equal(nxt, root):
            break
        dist = dist + dist[root]
        root = nxt
        ups.append(ups[-1][ups[-1]])
    value = np.arange(size)
    value[258:] = root[codes[1:]]           # entry e's last byte
    lens = dist[codes] + 1
    k = np.repeat(np.arange(n), lens)
    steps = np.cumsum(lens)[k] - 1 - np.arange(int(lens.sum()))
    node = codes[k]
    t = 0
    while steps.any():
        if t == len(ups):
            ups.append(ups[-1][ups[-1]])
        odd = (steps & 1).astype(bool)
        node[odd] = ups[t][node[odd]]
        steps >>= 1
        t += 1
    return value[node].astype(np.uint8)


def _lzw_decode(data: bytes) -> bytes:
    """TIFF LZW, new-style or old-style, segment by segment between clear
    codes; a stream that ends without its end code gives what it holds."""
    compat = len(data) >= 2 and data[0] == 0 and data[1] & 1
    bits = np.frombuffer(data + bytes(4), np.uint8).astype(np.int64)
    total = 8 * len(data)
    out, pos = [], 0
    while pos < total:
        count = 4096
        while True:
            codes, ends = _lzw_codes(bits, pos, total, compat, count)
            stop = np.flatnonzero((codes == 256) | (codes == 257))
            if stop.size or len(codes) < count:
                break
            count *= 4
        n = int(stop[0]) if stop.size else len(codes)
        out.append(_lzw_strings(codes[:n]))
        if not stop.size or codes[n] == 257:
            break
        pos = int(ends[n])
    return b"".join(a.tobytes() for a in out)


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


def _tiff_chunk(raw: bytes, compression: int, fill_order: int,
                jpeg_tables: bytes | None) -> bytes | np.ndarray:
    """One strip or tile's bytes, decompressed (JPEG: its decoded array)."""
    if fill_order == 2 and compression in _TIFF_BITREV:
        raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
    if compression == 5:
        return _lzw_decode(raw)
    if compression in (8, 32946):
        return zlib.decompress(raw)
    if compression == 32773:
        return _packbits_decode(raw)
    if compression == 7:
        return decode_jpeg(raw, tables=jpeg_tables)
    return raw


def decode_tiff(data: bytes) -> np.ndarray:
    """The first image of a TIFF or BigTIFF → (H, W) or (H, W, C), uint8,
    uint16 or float32, channels in file order: strips or tiles, chunky or
    planar samples, fill order 1 or 2, uncompressed, LZW (new-style or
    old-style), Deflate, PackBits or JPEG (compression 7, with the
    JPEGTables tag)."""
    if data[:2] == b"II":
        order = "<"
    elif data[:2] == b"MM":
        order = ">"
    else:
        raise ValueError("not a TIFF file")
    magic, = struct.unpack(order + "H", data[2:4])
    if magic == 42:
        big = False
        offset, = struct.unpack(order + "I", data[4:8])
    elif magic == 43:
        big = True
        size, zero, offset = struct.unpack(order + "HHQ", data[4:16])
        if size != 8 or zero:
            raise ValueError("bad BigTIFF header")
    else:
        raise ValueError("not a TIFF file")
    tags = _tiff_tags(data, order, offset, big)
    width, height = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    bits = set(tags.get(258, (1,)))
    compression = tags.get(259, (1,))[0]
    photometric = tags.get(262, (1,))[0]
    predictor = tags.get(317, (1,))[0]
    sample_format = tags.get(339, (1,))[0]
    planar = tags.get(284, (1,))[0]
    fill_order = tags.get(266, (1,))[0]
    if compression not in _TIFF_READ:
        raise _unported(f"TIFF compression {compression} "
                        f"({_TIFF_COMPRESSIONS.get(compression, 'unknown')})")
    if photometric not in (1, 2) and not (compression == 7 and photometric == 6):
        raise _unported(f"TIFF photometric interpretation {photometric}")
    if len(bits) != 1:
        raise _unported(f"TIFF with mixed sample depths {sorted(bits)}")
    if planar not in (1, 2) or fill_order not in (1, 2):
        raise ValueError(f"bad TIFF planar configuration {planar} or fill "
                         f"order {fill_order}")
    depth = bits.pop()
    if planar == 2 and spp > 1 and depth != 8:
        # cv2 here reads such a file's first plane as if its samples were
        # chunky: there is no reference to be equal to
        raise _unported(f"planar TIFF of {depth}-bit samples")
    dtypes = {(8, 1): "u1", (16, 1): "u2", (32, 3): "f4"}
    if (depth, sample_format) not in dtypes:
        raise _unported(f"TIFF with {depth}-bit samples of format "
                        f"{sample_format}")
    if predictor not in (1, 2) or (predictor == 2 and sample_format == 3):
        raise _unported(f"TIFF predictor {predictor}")
    dtype = np.dtype(order + dtypes[(depth, sample_format)])
    native = dtype.newbyteorder("=")
    tables = bytes(tags[347]) if 347 in tags else None
    if 322 in tags:                       # tiles
        bw, bh = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags[325]
    else:                                 # strips: tiles as wide as the image
        bw, bh = width, min(tags.get(278, (height,))[0], height)
        offsets, counts = tags[273], tags[279]
    across, down = -(-width // bw), -(-height // bh)
    planes = spp if planar == 2 else 1
    chunk_spp = 1 if planar == 2 else spp
    if len(offsets) < across * down * planes:
        raise ValueError("TIFF has fewer strips or tiles than its image")
    img = np.zeros((planes, down * bh, across * bw, chunk_spp), native)
    for i in range(across * down * planes):
        plane, rest = divmod(i, across * down)
        ty, tx = divmod(rest, across)
        # a strip holds only the image's rows; a tile is whole at the edges
        rows = bh if 322 in tags else min(bh, height - ty * bh)
        got = _tiff_chunk(data[offsets[i]:offsets[i] + counts[i]], compression,
                          fill_order, tables)
        if isinstance(got, np.ndarray):    # JPEG
            block = got.reshape(got.shape[0], got.shape[1], -1)[:rows, :bw]
            if block.shape[2] != chunk_spp or block.dtype != native:
                raise _unported(f"JPEG-in-TIFF with {block.shape[2]} "
                                f"components for {chunk_spp} samples")
        else:
            need = rows * bw * chunk_spp * dtype.itemsize
            if len(got) < need:
                raise ValueError("TIFF image data is truncated")
            block = np.frombuffer(got, dtype, count=rows * bw * chunk_spp) \
                .reshape(rows, bw, chunk_spp).astype(native)
            if predictor == 2:
                # horizontal differencing: a running sum along each row of
                # the chunk and sample, wrapping like the samples' own type
                block = np.cumsum(block, axis=1, dtype=native)
        img[plane, ty * bh:ty * bh + block.shape[0],
            tx * bw:tx * bw + block.shape[1]] = block
    img = img[:, :height, :width]
    img = np.moveaxis(img[..., 0], 0, -1) if planar == 2 else img[0]
    return img[..., 0] if spp == 1 else img


# ---------------------------------------------------------------- JPEG ----
# Huffman-coded JPEG, 8-bit, baseline (SOF0), extended (SOF1) and
# progressive (SOF2), gray or YCbCr (or RGB by the Adobe marker), any
# integral sampling factors, restart intervals; pixel-equal to cv2 5.0.0's
# libjpeg-turbo 3.1.2 (decode_jpeg). The entropy decoder loops once per
# Huffman symbol over a 16-bit lookup table; the rest is whole-array numpy.
_JPEG_UNPORTED = {0xC3: "lossless JPEG", 0xC5: "differential JPEG",
                  0xC6: "differential progressive JPEG",
                  0xC7: "differential lossless JPEG",
                  0xC9: "arithmetic-coded JPEG",
                  0xCA: "arithmetic-coded progressive JPEG",
                  0xCB: "arithmetic-coded lossless JPEG",
                  0xCC: "arithmetic-coded JPEG",
                  0xCD: "arithmetic-coded differential JPEG",
                  0xCE: "arithmetic-coded differential JPEG",
                  0xCF: "arithmetic-coded differential JPEG"}
# _ZIGZAG[k]: the natural (row-major) index of the k-th coefficient in
# zigzag order
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
# jidctint.c's constants, CONST_BITS = 13, PASS1_BITS = 2
_FIX = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373,
            c1175=9633, c1501=12299, c1847=15137, c1961=16069, c2053=16819,
            c2562=20995, c3072=25172)
# the IDCT's output range limit (jdmaster.c prepare_range_limit_table),
# indexed by the descaled value & 1023: x + 128 clamped, wrapping far out
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255),
                              np.zeros(384), np.arange(0, 128)]).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _jpeg_huffman(counts: bytes, symbols: bytes):
    """(code lengths, symbols) of a 16-bit lookup table: entry v holds the
    code that begins the 16 bits v (length 0: no code). Cached: the files
    of one encoder share their tables."""
    lens = np.zeros(1 << 16, np.int64)
    syms = np.zeros(1 << 16, np.int64)
    code, at = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("bad JPEG Huffman table")
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            lens[lo:hi] = length
            syms[lo:hi] = symbols[at]
            code += 1
            at += 1
        code <<= 1
    return lens.tolist(), syms.tolist()


def _jpeg_bits(part: bytes):
    """32-bit big-endian windows of an unstuffed restart interval, one per
    byte offset, zero past its end (libjpeg feeds zeros)."""
    b = np.frombuffer(part + bytes(8), np.uint8).astype(np.int64)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()


def _jpeg_scan_data(data: bytes, pos: int):
    """(the scan's restart intervals, unstuffed; the offset of the marker
    that ends it)."""
    parts, start = [], pos
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            raise ValueError("JPEG scan runs past the end of the file")
        m = data[i + 1]
        if m == 0x00 or m == 0xFF:
            pos = i + 1 if m == 0xFF else i + 2
            continue
        parts.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= m <= 0xD7:
            start = pos = i + 2
            continue
        return parts, i


class _Jpeg:
    """Markers, tables and coefficients of one JPEG stream."""

    def __init__(self):
        self.qt, self.dc, self.ac = {}, {}, {}
        self.restart = 0
        self.frame = None
        self.jfif = False
        self.adobe = None
        self.layouts = {}

    def tables(self, marker: int, seg: bytes):
        if marker == 0xC4:
            at = 0
            while at < len(seg):
                tc, th = seg[at] >> 4, seg[at] & 15
                counts = seg[at + 1:at + 17]
                n = sum(counts)
                table = _jpeg_huffman(bytes(counts), bytes(seg[at + 17:at + 17 + n]))
                (self.dc if tc == 0 else self.ac)[th] = table
                at += 17 + n
        elif marker == 0xDB:
            at = 0
            while at < len(seg):
                pq, tq = seg[at] >> 4, seg[at] & 15
                if pq:
                    q = np.frombuffer(seg[at + 1:at + 129], ">u2").astype(np.int64)
                    at += 129
                else:
                    q = np.frombuffer(seg[at + 1:at + 65], np.uint8).astype(np.int64)
                    at += 65
                nat = np.empty(64, np.int64)
                nat[_ZIGZAG] = q
                self.qt[tq] = nat
        elif marker == 0xDD:
            self.restart, = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            self.jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            self.adobe = seg[11]

    def start_frame(self, marker: int, seg: bytes):
        precision, height, width, n = struct.unpack(">BHHB", seg[:6])
        if precision != 8:
            raise _unported(f"{precision}-bit JPEG")
        if height == 0:
            raise _unported("JPEG whose height comes in a DNL marker")
        if n == 4:
            raise _unported("CMYK/YCCK (four-component) JPEG")
        if n not in (1, 3):
            raise _unported(f"JPEG with {n} components")
        if len(seg) < 6 + 3 * n:
            raise ValueError("truncated JPEG frame header")
        comps = []
        for i in range(n):
            cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
            comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
        hmax = max(c["h"] for c in comps)
        vmax = max(c["v"] for c in comps)
        mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
        for c in comps:
            if hmax % c["h"] or vmax % c["v"]:
                raise _unported("JPEG with non-integral sampling ratios")
            c["bw"], c["bh"] = mx * c["h"], my * c["v"]       # allocated blocks
            c["w"] = -(-width * c["h"] // hmax)                 # samples
            c["ht"] = -(-height * c["v"] // vmax)
            c["coef"] = [0] * (c["bw"] * c["bh"] * 64)
            c["bits"] = [-1] * 64                                # last Al per coefficient
            c["q"] = None
        self.frame = dict(width=width, height=height, comps=comps, hmax=hmax,
                          vmax=vmax, mx=mx, my=my,
                          progressive=marker == 0xC2)

    def layout(self, comps):
        """(the scan's blocks in order as (component's slot, block base),
        blocks per MCU): a lone component's blocks in raster order over
        its own size, else each MCU's blocks component by component.
        Cached: progressive scans repeat their component sets."""
        f = self.frame
        key = tuple(c["id"] for c in comps)
        if key in self.layouts:
            return self.layouts[key]
        if len(comps) == 1:
            c = comps[0]
            bw, bh = -(-c["w"] // 8), -(-c["ht"] // 8)
            out = ([(0, (by * c["bw"] + bx) * 64) for by in range(bh)
                    for bx in range(bw)], 1)
        else:
            blocks = []
            for my in range(f["my"]):
                for mx in range(f["mx"]):
                    for s, c in enumerate(comps):
                        for v in range(c["v"]):
                            for h in range(c["h"]):
                                by, bx = my * c["v"] + v, mx * c["h"] + h
                                blocks.append((s, (by * c["bw"] + bx) * 64))
            out = (blocks, sum(c["h"] * c["v"] for c in comps))
        self.layouts[key] = out
        return out

    def scan(self, seg: bytes, parts):
        f = self.frame
        if f is None:
            raise ValueError("JPEG scan before its frame header")
        n = seg[0]
        byid = {c["id"]: c for c in f["comps"]}
        comps, dcs, acs = [], [], []
        for i in range(n):
            cid, t = seg[1 + 2 * i:3 + 2 * i]
            comps.append(byid[cid])
            dcs.append(self.dc.get(t >> 4))
            acs.append(self.ac.get(t & 15))
        ss, se, a = seg[1 + 2 * n:4 + 2 * n]
        ah, al = a >> 4, a & 15
        for c in comps:       # the quantisation table the scan's data used
            if c["q"] is None:
                if c["tq"] not in self.qt:
                    raise ValueError("JPEG component without its quantisation table")
                c["q"] = self.qt[c["tq"]]
        if not f["progressive"] and (ss, se, ah, al) != (0, 63, 0, 0):
            raise ValueError(f"bad sequential JPEG scan {ss}-{se} {ah}/{al}")
        blocks, per_mcu = self.layout(comps)
        per = (self.restart or len(blocks)) * per_mcu
        coefs = [c["coef"] for c in comps]
        for i, part in enumerate(parts):
            group = blocks[i * per:(i + 1) * per]
            if not group:
                break
            if ss == 0:
                if ah == 0:
                    _decode_dc(_jpeg_bits(part), group, coefs, dcs, acs,
                               al, f["progressive"])
                else:
                    _refine_dc(_jpeg_bits(part), group, coefs, al)
            elif ah == 0:
                _decode_ac_first(_jpeg_bits(part), group, coefs[0], acs[0],
                                 ss, se, al)
            else:
                _refine_ac(_jpeg_bits(part), group, coefs[0], acs[0], ss, se, al)
        for c in comps:
            for k in range(ss, se + 1):
                c["bits"][k] = al


def _decode_dc(win, blocks, coefs, dcs, acs, al, progressive):
    """Sequential blocks (DC and all 63 AC coefficients) or, progressive,
    the first DC scan, of one restart interval."""
    pos = 0
    pred = [0] * len(coefs)
    for slot, base in blocks:
        lens, syms = dcs[slot]
        v = (win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
        n = lens[v]
        if not n:
            raise ValueError("corrupt JPEG Huffman data")
        s = syms[v]
        pos += n
        diff = 0
        if s:
            diff = (win[pos >> 3] >> (32 - s - (pos & 7))) & ((1 << s) - 1)
            pos += s
            if diff < 1 << (s - 1):
                diff += 1 - (1 << s)
        pred[slot] += diff
        coef = coefs[slot]
        coef[base] = pred[slot] << al
        if progressive:
            continue
        alens, asyms = acs[slot]
        k = 1
        while k < 64:
            v = (win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
            n = alens[v]
            if not n:
                raise ValueError("corrupt JPEG Huffman data")
            rs = asyms[v]
            pos += n
            s = rs & 15
            if s:
                k += rs >> 4
                val = (win[pos >> 3] >> (32 - s - (pos & 7))) & ((1 << s) - 1)
                pos += s
                if val < 1 << (s - 1):
                    val += 1 - (1 << s)
                if k < 64:
                    coef[base + k] = val
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break


def _refine_dc(win, blocks, coefs, al):
    pos = 0
    bit = 1 << al
    for slot, base in blocks:
        if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
            coefs[slot][base] |= bit
        pos += 1


def _decode_ac_first(win, blocks, coef, table, ss, se, al):
    lens, syms = table
    pos, eobrun = 0, 0
    for _, base in blocks:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            v = (win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
            n = lens[v]
            if not n:
                raise ValueError("corrupt JPEG Huffman data")
            rs = syms[v]
            pos += n
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                val = (win[pos >> 3] >> (32 - s - (pos & 7))) & ((1 << s) - 1)
                pos += s
                if val < 1 << (s - 1):
                    val += 1 - (1 << s)
                if k <= se:
                    coef[base + k] = val * (1 << al)
                k += 1
            elif r == 15:
                k += 16
            else:
                eobrun = 1 << r
                if r:
                    eobrun += (win[pos >> 3] >> (32 - r - (pos & 7))) & ((1 << r) - 1)
                    pos += r
                eobrun -= 1
                break


def _refine_ac(win, blocks, coef, table, ss, se, al):
    """jdphuff.c decode_mcu_AC_refine: correction bits for coefficients
    already nonzero, new ones of magnitude 1 << al, end-of-band runs."""
    lens, syms = table
    p1, m1 = 1 << al, -1 << al
    pos, eobrun = 0, 0
    for _, base in blocks:
        k = ss
        if eobrun == 0:
            while k <= se:
                v = (win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
                n = lens[v]
                if not n:
                    raise ValueError("corrupt JPEG Huffman data")
                rs = syms[v]
                pos += n
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if (win[pos >> 3] >> (31 - (pos & 7))) & 1 else m1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[pos >> 3] >> (32 - r - (pos & 7))) & ((1 << r) - 1)
                        pos += r
                    break
                while k <= se:
                    c = coef[base + k]
                    if c:
                        if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                            coef[base + k] = c + (p1 if c >= 0 else m1)
                        pos += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s and k <= se:
                    coef[base + k] = s
                k += 1
        if eobrun:
            while k <= se:
                c = coef[base + k]
                if c:
                    if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                        coef[base + k] = c + (p1 if c >= 0 else m1)
                    pos += 1
                k += 1
            eobrun -= 1


def _idct_1d(x, shift):
    """jidctint.c's 1-D islow pass on the 8 inputs x[0..7] (int64 arrays),
    outputs descaled by `shift` bits."""
    F = _FIX
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * F["c0541"]
    tmp2 = z1 - z3 * F["c1847"]
    tmp3 = z1 + z2 * F["c0765"]
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * F["c1175"]
    o0 = o0 * F["c0298"]
    o1 = o1 * F["c2053"]
    o2 = o2 * F["c3072"]
    o3 = o3 * F["c1501"]
    z1 = z1 * -F["c0899"]
    z2 = z2 * -F["c2562"]
    z3 = z3 * -F["c1961"] + z5
    z4 = z4 * -F["c0390"] + z5
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in
            (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
             t13 - o0, t12 - o1, t11 - o2, t10 - o3)]


def _idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(N, 64) natural-order coefficients → (N, 8, 8) uint8 samples, the
    integer IDCT of jidctint.c (cv2's default method), bit for bit."""
    d = (coef.astype(np.int64) * q).reshape(-1, 8, 8)
    ws = np.stack(_idct_1d([d[:, r] for r in range(8)], 11), axis=1)
    out = np.stack(_idct_1d([ws[:, :, c] for c in range(8)], 18), axis=2)
    return _IDCT_LIMIT[out & 1023]


def _upsample(p: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """jdsample.c: a plane of downsampled_height x downsampled_width up by
    (fy, fx): the triangle ("fancy") filters for 2x1, 2x2 and 1x2 where
    libjpeg-turbo takes them, sample replication otherwise."""
    if fy == fx == 1:
        return p
    h, w = p.shape
    v = p.astype(np.int64)
    if fx == 2 and fy in (1, 2) and w > 2:
        if fy == 2:   # column sums: 3 x nearer row + further row
            up = np.concatenate([v[:1], v[:-1]])
            down = np.concatenate([v[1:], v[-1:]])
            rows = np.empty((2 * h, w), np.int64)
            rows[0::2] = 3 * v + up
            rows[1::2] = 3 * v + down
            left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
            right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
            out = np.empty((2 * h, 2 * w), np.int64)
            out[:, 0::2] = (3 * rows + left + 8) >> 4
            out[:, 1::2] = (3 * rows + right + 7) >> 4
        else:
            left = np.concatenate([v[:, :1], v[:, :-1]], axis=1)
            right = np.concatenate([v[:, 1:], v[:, -1:]], axis=1)
            out = np.empty((h, 2 * w), np.int64)
            out[:, 0::2] = (3 * v + left + 1) >> 2
            out[:, 1::2] = (3 * v + right + 2) >> 2
        return out.astype(np.uint8)
    if fx == 1 and fy == 2:
        up = np.concatenate([v[:1], v[:-1]])
        down = np.concatenate([v[1:], v[-1:]])
        out = np.empty((2 * h, w), np.int64)
        out[0::2] = (3 * v + up + 1) >> 2
        out[1::2] = (3 * v + down + 2) >> 2
        return out.astype(np.uint8)
    return np.repeat(np.repeat(p, fy, axis=0), fx, axis=1)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's tables: R = Y + round(1.402 (Cr-128)), B = Y +
    round(1.772 (Cb-128)), G = Y + ((-0.34414 (Cb-128) - 0.71414 (Cr-128))
    in 16-bit fixed point, rounded), each clamped to 0..255."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda f: int(f * 65536 + 0.5)  # noqa: E731
    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    yy = y.astype(np.int64)
    r = yy + cr_r[cr]
    g = yy + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yy + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, tables: bytes | None = None) -> np.ndarray:
    """JPEG bytes → (H, W) uint8 gray or (H, W, 3) uint8 RGB in file order,
    as cv2's imread with libjpeg-turbo 3.1.2 gives it (in B, G, R there):
    islow IDCT, fancy upsampling, jdcolor.c's YCbCr tables. `tables`: an
    abbreviated stream of tables read first (TIFF's JPEGTables)."""
    jp = _Jpeg()
    for stream, tables_only in ((tables, True), (data, False)):
        if stream is None:
            continue
        if stream[:2] != b"\xff\xd8":
            raise ValueError("not a JPEG stream")
        pos = 2
        while True:
            i = stream.find(b"\xff", pos)
            while 0 <= i < len(stream) - 1 and stream[i + 1] == 0xFF:
                i += 1
            if i < 0 or i + 1 >= len(stream):
                if tables_only:
                    break
                raise ValueError("JPEG stream ends before its EOI marker")
            marker = stream[i + 1]
            pos = i + 2
            if marker == 0xD9:
                break
            if marker == 0xD8 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
                continue
            length, = struct.unpack(">H", stream[pos:pos + 2])
            seg = stream[pos + 2:pos + length]
            pos += length
            if marker in _JPEG_UNPORTED:
                raise _unported(_JPEG_UNPORTED[marker])
            if marker in (0xC0, 0xC1, 0xC2):
                jp.start_frame(marker, seg)
            elif marker == 0xDA:
                parts, pos = _jpeg_scan_data(stream, pos)
                jp.scan(seg, parts)
            else:
                jp.tables(marker, seg)
    f = jp.frame
    if f is None:
        raise ValueError("JPEG stream has no frame header")
    planes = []
    for c in f["comps"]:
        if c["q"] is None:
            raise ValueError("JPEG component never scanned")
        if f["progressive"] and any(b != 0 for b in c["bits"][:10]):
            raise _unported("progressive JPEG whose scans leave coefficients "
                            "incomplete (block smoothing)")
        coef = np.asarray(c["coef"], np.int64).reshape(-1, 64)
        nat = np.empty_like(coef)
        nat[:, _ZIGZAG] = coef
        px = _idct_islow(nat, c["q"]).reshape(c["bh"], c["bw"], 8, 8) \
            .transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        plane = px[:c["ht"], :c["w"]]
        up = _upsample(plane, f["vmax"] // c["v"], f["hmax"] // c["h"])
        planes.append(up[:f["height"], :f["width"]])
    if len(planes) == 1:
        return planes[0]
    ids = tuple(c["id"] for c in f["comps"])
    rgb = (jp.adobe == 0) if jp.adobe is not None and not jp.jfif \
        else (not jp.jfif and ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, axis=-1)
    return _ycc_to_rgb(*planes)


# ---------------------------------------------------------- one image ----
# cv2's float COLOR_BGR2GRAY: float32 weights, fused multiply-adds. Its
# vector loop (8 pixels a step) gives fma(R, wr, fma(B, wb, G wg)); in a
# row's tail of W mod 8 pixels, when it holds 4 or more, the first and
# third give fma(R, wr, fma(G, wg, B wb)) (measured against cv2 5.0.0 on
# x86-64). A float64 sum of an exact float32 product and a float32 value,
# rounded once to float32, is the fused multiply-add.
_GRAY_F32 = tuple(float(np.float32(v)) for v in (0.299, 0.587, 0.114))


def _fma32(a: np.ndarray, w: float, c: np.ndarray) -> np.ndarray:
    return (a * w + c).astype(np.float32).astype(np.float64)


def _gray_float(img: np.ndarray) -> np.ndarray:
    r, g, b = (img[..., i].astype(np.float32).astype(np.float64) for i in range(3))
    wr, wg, wb = _GRAY_F32
    gray = _fma32(r, wr, _fma32(b, wb, (g * wg).astype(np.float32).astype(np.float64)))
    width = img.shape[1]
    tail = width // 8 * 8
    if width - tail >= 4:
        cols = [tail, tail + 2]
        gb = (b[:, cols] * wb).astype(np.float32).astype(np.float64)
        gray[:, cols] = _fma32(r[:, cols], wr, _fma32(g[:, cols], wg, gb))
    return gray.astype(np.float32)


def to_gray(img: np.ndarray) -> np.ndarray:
    """(H, W, C) in file order → (H, W): gray + alpha keeps the gray;
    RGB(A) of 8 or 16 bits takes cv2's COLOR_BGR2GRAY weights and
    rounding."""
    if img.shape[-1] == 2:
        return img[..., 0]
    if img.dtype.kind == "f":
        return _gray_float(img)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    acc = (b.astype(np.int64) * _GRAY_B + g.astype(np.int64) * _GRAY_G
           + r.astype(np.int64) * _GRAY_R + (1 << (_GRAY_SHIFT - 1)))
    return (acc >> _GRAY_SHIFT).astype(img.dtype)


def decode_file(path: str | Path) -> np.ndarray:
    """A PNG, TIFF or JPEG file → its array (decode_png / decode_tiff /
    decode_jpeg)."""
    data = Path(path).read_bytes()
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data)
    if data[:2] in (b"II", b"MM"):
        return decode_tiff(data)
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data)
    raise OSError(f"could not decode image {path}: neither PNG, TIFF nor JPEG")


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

