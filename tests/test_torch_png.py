"""The port's PNG reader (``utils/png.py decode_png``, with ``native/png.cpp``)
against ``cv2.imdecode(..., IMREAD_COLOR)``, on the CPU.

cv2 writes PNG files with libpng's adaptive filters, so its files mix the row
filters; files of 8-bit gray, RGB and RGBA at several sizes and compression
levels must decode to cv2's pixels exactly.  Files written here with one row
filter each (0 none, 1 sub, 2 up, 3 average, 4 Paeth, and a mix) make sure that
every filter is taken.  Bytes that are not a whole PNG file, and PNG files of
another kind (16-bit, palette, interlaced), give None, as ``cv2.imdecode``
gives None for the bytes it cannot read.
"""

import struct
import zlib

import numpy as np
import pytest

from yolo_puncture_tpu_torch.utils.png import _chunk, decode_image, decode_png, encode_png_rgb

cv2 = pytest.importorskip("cv2")

SIG = b"\x89PNG\r\n\x1a\n"


def _image(shape, seed):
    """Noise in the lower half, smooth ramps in the upper half (rows that favour
    the sub, up, average and Paeth filters)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    h, w = shape[:2]
    ramp = (np.add.outer(np.arange(h) * 3, np.arange(w) * 5) % 256).astype(np.uint8)
    a[: h // 2] = (ramp[: h // 2, :, None] if a.ndim == 3 else ramp[: h // 2]) if h > 1 else a[: h // 2]
    return a


def _filter_types(data: bytes, h: int, row_bytes: int):
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    return {raw[y * (row_bytes + 1)] for y in range(h)}


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("shape", [(1, 1), (7, 9), (40, 33), (33, 17, 3), (64, 48, 3), (20, 31, 4), (96, 160, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_decode_png_equals_cv2_imdecode(shape, level):
    img = _image(shape, seed=sum(shape) + level)
    ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    assert ok
    data = buf.tobytes()
    ref = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    got = decode_png(data)
    assert got is not None and got.dtype == np.uint8 and got.shape == ref.shape == (*shape[:2], 3)
    np.testing.assert_array_equal(got, ref)
    assert decode_image(data) is not None


def test_cv2_files_mix_the_row_filters():
    """libpng's adaptive filtering picks more than one filter in one file."""
    img = _image((64, 48, 3), seed=1)
    ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    assert len(_filter_types(buf.tobytes(), 64, 48 * 3)) >= 2


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(rgb: np.ndarray, kinds) -> bytes:
    """An RGB PNG whose row y is stored with filter ``kinds[y % len(kinds)]``."""
    h, w, _ = rgb.shape
    x = rgb.reshape(h, w * 3).astype(np.int64)
    rows = []
    for y in range(h):
        k = kinds[y % len(kinds)]
        prior = x[y - 1] if y else np.zeros(w * 3, np.int64)
        out = np.empty(w * 3, np.int64)
        for i in range(w * 3):
            a = x[y, i - 3] if i >= 3 else 0
            b = prior[i]
            c = prior[i - 3] if i >= 3 else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[k]
            out[i] = (x[y, i] - pred) % 256
        rows.append(bytes([k]) + out.astype(np.uint8).tobytes())
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return SIG + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b"")


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_every_row_filter(kinds):
    rgb = _image((13, 11, 3), seed=len(kinds) + kinds[0])
    data = _filtered_png(rgb, kinds)
    assert _filter_types(data, 13, 33) == set(kinds)
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(ref, rgb[..., ::-1])
    np.testing.assert_array_equal(decode_png(data), ref)


def test_round_trip_of_the_writer():
    rgb = _image((30, 50, 3), seed=4)
    np.testing.assert_array_equal(decode_png(encode_png_rgb(rgb)), rgb[..., ::-1])


def test_what_cv2_cannot_read_or_the_reader_does_not_take_gives_none():
    img = _image((24, 20, 3), seed=5)
    data = cv2.imencode(".png", img)[1].tobytes()
    bad_crc = bytearray(data)
    bad_crc[30] ^= 0xFF                                    # inside IHDR's CRC or IDAT
    cases = {
        "garbage": b"not an image",
        "empty": b"",
        "cut short": data[: len(data) // 2],
        "flipped byte": bytes(bad_crc),
        "jpeg": cv2.imencode(".jpg", img)[1].tobytes(),
        "16-bit": cv2.imencode(".png", img.astype(np.uint16) * 257)[1].tobytes(),
        "palette": SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 3, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(b"\x00\x00\x00" * 2)) + _chunk(b"IEND", b""),
        "interlaced": SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 1))
        + _chunk(b"IDAT", zlib.compress(bytes(14))) + _chunk(b"IEND", b""),
        "bad filter type": SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(b"\x07\x01\x02\x03")) + _chunk(b"IEND", b""),
    }
    for name, d in cases.items():
        assert decode_png(d) is None, name
    for name in ("garbage", "cut short"):
        assert cv2.imdecode(np.frombuffer(cases[name], np.uint8), cv2.IMREAD_COLOR) is None, name
        assert decode_image(cases[name]) is None, name
    assert decode_image(b"") is None                     # cv2.imdecode raises on an empty buffer
    # what the reader leaves to cv2, cv2 reads
    np.testing.assert_array_equal(decode_image(cases["jpeg"]), cv2.imdecode(np.frombuffer(cases["jpeg"], np.uint8),
                                                                            cv2.IMREAD_COLOR))
