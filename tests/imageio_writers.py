"""Writers of the image layouts cv2 cannot write: TIFFs in tiles, with planar
samples, fill order 2, BigTIFF, new-style and old-style LZW; PNGs with
Adam7 interlacing, palettes (with or without tRNS) and depths below 8.
Each builds the file from its layout in the format's specification; the
tests and the fixture script then read it with cv2 (or PIL) for the
reference, so a writer error shows as a disagreement with cv2."""
from __future__ import annotations

import struct
import zlib

import numpy as np

# ------------------------------------------------------------------ LZW --
# width of the j-th code of a segment (after a clear code): new-style
# TIFF LZW widens one code early, old-style (LSB first) on time
_WIDEN = {False: (254, 766, 1790), True: (255, 767, 1791)}


def lzw_encode(data: bytes, old: bool = False, clear_every: int = 0) -> bytes:
    """TIFF LZW of `data`: a clear code first, one when the table is full
    (and, with `clear_every`, after that many codes), the end code last.
    `old`: the old-style variant, codes least significant bit first."""
    codes = []                       # (code, index in its segment)

    def emit(code, j):
        codes.append((code, j))

    table = {bytes([i]): i for i in range(256)}
    j, nxt, w = 0, 258, b""
    emit(256, j)
    j = 0
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        emit(table[w], j)
        j += 1
        table[wc] = nxt
        nxt += 1
        w = bytes([byte])
        if nxt >= 4093 or (clear_every and j >= clear_every):
            emit(256, j)
            table = {bytes([i]): i for i in range(256)}
            j, nxt = 0, 258
    if w:
        emit(table[w], j)
        j += 1
    emit(257, j)
    bits, nbits = 0, 0
    out = bytearray()
    for code, j in codes:
        width = 9 + sum(j >= t for t in _WIDEN[old])
        if old:
            bits |= code << nbits
            nbits += width
            while nbits >= 8:
                out.append(bits & 0xFF)
                bits >>= 8
                nbits -= 8
        else:
            bits = (bits << width) | code
            nbits += width
            while nbits >= 8:
                out.append((bits >> (nbits - 8)) & 0xFF)
                nbits -= 8
            bits &= (1 << nbits) - 1
    if nbits:
        out.append((bits << (8 - nbits)) & 0xFF if not old else bits & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of a repeated byte as runs, the rest as literals."""
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        lit = data[i:i + 128]
        out += bytes([len(lit) - 1]) + lit
        i += len(lit)
    return bytes(out)


# ----------------------------------------------------------------- TIFF --
_COMPRESS = {1: lambda b: b, 8: lambda b: zlib.compress(b, 6),
             32773: packbits_encode}
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def tiff(img: np.ndarray, *, compression: int = 1, tile=None,
         rows_per_strip=None, planar: bool = False, fill_order: int = 1,
         big: bool = False, order: str = "<", predictor: int = 1,
         old_lzw: bool = False) -> bytes:
    """A TIFF (or BigTIFF) of img (H, W[, C]) uint8/uint16/float32: strips
    of `rows_per_strip` rows or tiles of `tile` (height, width), chunky or
    planar samples, compression 1, 5 (LZW), 8 or 32773, fill order 2 as
    bit-reversed bytes."""
    img = img if img.ndim == 3 else img[..., None]
    h, w, spp = img.shape
    dtype = img.dtype
    planes = [img[..., s:s + 1] for s in range(spp)] if planar else [img]
    if tile:
        th, tw = tile
    else:
        th, tw = (rows_per_strip or h), w
    across, down = -(-w // tw), -(-h // th)
    chunks = []
    for plane in planes:
        for ty in range(down):
            for tx in range(across):
                block = plane[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
                if tile:       # tiles are whole: pad at the edges
                    pad = np.zeros((th, tw, block.shape[2]), dtype)
                    pad[:block.shape[0], :block.shape[1]] = block
                    block = pad
                if predictor == 2:
                    block = block.copy()
                    block[:, 1:] = np.diff(block, axis=1)
                raw = block.astype(dtype.newbyteorder(order)).tobytes()
                if compression == 5:
                    raw = lzw_encode(raw, old=old_lzw, clear_every=700)
                else:
                    raw = _COMPRESS[compression](raw)
                if fill_order == 2:
                    raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
                chunks.append(raw)
    bits = 8 * dtype.itemsize
    fmt = 3 if dtype.kind == "f" else 1
    head = 16 if big else 8
    offsets, at = [], head
    for c in chunks:
        offsets.append(at)
        at += len(c) + (len(c) & 1)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
               (259, 3, [compression]), (262, 3, [2 if spp >= 3 else 1]),
               (277, 3, [spp]), (284, 3, [2 if planar else 1]),
               (339, 3, [fmt] * spp)]
    if fill_order != 1:
        entries.append((266, 3, [fill_order]))
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if spp == 4:
        entries.append((338, 3, [2]))
    long_type = 16 if big else 4
    if tile:
        entries += [(322, 4, [tw]), (323, 4, [th]), (324, long_type, offsets),
                    (325, long_type, [len(c) for c in chunks])]
    else:
        entries += [(273, long_type, offsets), (278, 4, [th]),
                    (279, long_type, [len(c) for c in chunks])]
    entries.sort()
    sizes = {3: "H", 4: "I", 16: "Q"}
    inline = 8 if big else 4
    extra = bytearray()
    ifd_at = at
    entry_size = 20 if big else 12
    count_size = 8 if big else 2
    extra_at = ifd_at + count_size + entry_size * len(entries) + (8 if big else 4)
    body = bytearray(struct.pack(order + ("Q" if big else "H"), len(entries)))
    for tag, kind, values in entries:
        packed = struct.pack(order + sizes[kind] * len(values), *values)
        head_fmt = order + ("HHQ" if big else "HHI")
        body += struct.pack(head_fmt, tag, kind, len(values))
        if len(packed) <= inline:
            body += packed + bytes(inline - len(packed))
        else:
            body += struct.pack(order + ("Q" if big else "I"), extra_at + len(extra))
            extra += packed + bytes(len(packed) & 1)
    body += bytes(8 if big else 4)
    magic = (b"II" if order == "<" else b"MM")
    if big:
        header = magic + struct.pack(order + "HHHQ", 43, 8, 0, ifd_at)
    else:
        header = magic + struct.pack(order + "HI", 42, ifd_at)
    data = bytearray(header)
    for c in chunks:
        data += c + bytes(len(c) & 1)
    return bytes(data + body + extra)


# ------------------------------------------------------------------ PNG --
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _rows(samples: np.ndarray, depth: int, filt: int) -> bytes:
    """Filtered scanlines of samples (h, w, ch): packed most significant
    bits first below 8 bits; every row with filter `filt` (0 None, 1 Sub,
    2 Up)."""
    h, w, ch = samples.shape
    if h == 0 or w == 0:
        return b""
    if depth == 16:
        lines = samples.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        lines = samples.astype(np.uint8).reshape(h, -1)
    else:
        flat = samples.reshape(h, w * ch).astype(np.uint8)
        per = 8 // depth
        pad = (-flat.shape[1]) % per
        flat = np.concatenate([flat, np.zeros((h, pad), np.uint8)], axis=1)
        groups = flat.reshape(h, -1, per)
        shifts = np.arange(8 - depth, -1, -depth)
        lines = (groups << shifts).sum(axis=2).astype(np.uint8)
    bpp = max(1, ch * depth // 8)
    out = bytearray()
    prev = np.zeros(lines.shape[1], np.uint8)
    for line in lines:
        if filt == 1:
            f = line.copy()
            f[bpp:] = line[bpp:] - line[:-bpp]
        elif filt == 2:
            f = line - prev
        else:
            f = line
        out += bytes([filt]) + f.tobytes()
        prev = line
    return bytes(out)


def png(samples: np.ndarray, *, depth: int = 8, color: int = 0,
        interlace: bool = False, palette=None, trns=None, filt: int = 1) -> bytes:
    """A PNG of samples (H, W[, C]) (palette indices for colour type 3) at
    `depth` bits, Adam7-interlaced or not, with PLTE and tRNS chunks."""
    s = samples if samples.ndim == 3 else samples[..., None]
    h, w, _ = s.shape
    if interlace:
        raw = b"".join(_rows(s[y0::dy, x0::dx], depth, filt)
                       for x0, y0, dx, dy in _ADAM7)
    else:
        raw = _rows(s, depth, filt)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", np.asarray(trns, np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")
