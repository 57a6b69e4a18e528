"""Times TIFF LZW decoding of a file's strips on this host: the port's
segment decoder (thyroid_tpu_torch.data.imageio._lzw_decode) against the
loop decoder it replaced (kept in tests/test_torch_imageio_rest.py as
`_lzw_loop`), best of 3 each, and checks that both give the same bytes.
Run from the repository root:

    python tests/fixtures/imageio/time_lzw.py [tests/fixtures/imageio/lzw512_u16.tif]
"""
from __future__ import annotations

import struct
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

from tests.test_torch_imageio_rest import _lzw_loop  # noqa: E402
from thyroid_tpu_torch.data import imageio  # noqa: E402


def strips(data: bytes):
    order = "<" if data[:2] == b"II" else ">"
    offset, = struct.unpack(order + "I", data[4:8])
    tags = imageio._tiff_tags(data, order, offset, False)
    if tags.get(259, (1,))[0] != 5:
        raise SystemExit("not an LZW TIFF")
    return [data[a:a + n] for a, n in zip(tags[273], tags[279])]


def best_ms(fn, chunks):
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = [fn(c) for c in chunks]
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), out


def main():
    path = Path(sys.argv[1] if len(sys.argv) > 1
                else ROOT / "tests" / "fixtures" / "imageio" / "lzw512_u16.tif")
    chunks = strips(path.read_bytes())
    new_ms, new = best_ms(imageio._lzw_decode, chunks)
    old_ms, old = best_ms(_lzw_loop, chunks)
    print(f"{path.name}: {len(chunks)} strips, {sum(map(len, chunks))} bytes -> "
          f"{sum(map(len, new))}; segment decoder {new_ms:.1f} ms, loop decoder "
          f"{old_ms:.1f} ms (best of 3), bytes equal: {new == old}")


if __name__ == "__main__":
    main()
