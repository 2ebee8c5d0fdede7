"""The port's zlib image reader (``libstacker_tpu_torch/csrc/image_io.cpp``)
against cv2, against the JAX package's PIL route, and through the file
entry points.

Every test runs with ``native_loader.ORDER`` narrowed to the zlib reader
(``native_loader.library("zlib")``), so it is the one under test wherever
the full loader (``native/stacker_io.cpp``) also builds; the tests of the
route to PIL run under both.  Every PNG and TIFF case decodes bitwise equal to
``cv2.imread(IMREAD_UNCHANGED)`` (BGR to RGB, alpha dropped; at 8 bits a
16-bit sample's high byte, at 16 bits an 8-bit sample x257) and to the
samples the test wrote, at 8 and at 16 bits; and to the JAX package's PIL
route wherever PIL keeps the depth.  cv2 writes the 8/16-bit grey, RGB
and RGBA PNGs with a forced ``IMWRITE_PNG_FILTER``, and the TIFFs; PIL the
palette and 1-bit files; the writers below the rest (Adam7, 2/4-bit grey,
tRNS, a filter forced per row, a big-endian TIFF, old-style LZW).
``ecc_match(files, preserve_depth=True)`` on 48-bit files equals
``ecc_match_arrays`` on the array written, and the JAX package's
``ecc_match_arrays`` within ``tests/test_torch_pipeline_ecc.py``'s bar
(interior max 0.02).
"""

import io
import shutil
import struct
import threading
import time
import zlib

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("scipy")

from PIL import Image  # noqa: E402

import libstacker_tpu as J  # noqa: E402
from libstacker_tpu.utils import io as jio  # noqa: E402

import libstacker_tpu_torch as P  # noqa: E402
from _torch_parity import burst  # noqa: E402
from libstacker_tpu_torch import errors  # noqa: E402
from libstacker_tpu_torch.utils import io as pio  # noqa: E402
from libstacker_tpu_torch.utils import native_loader as nl  # noqa: E402

torch.set_num_threads(2)

H, W = 23, 37


@pytest.fixture(scope="module", autouse=True)
def reader():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the zlib reader is built with it")
    lib = nl.library(nl.ZLIB)
    assert lib is not None, nl._errors.get(nl.ZLIB)
    return lib


@pytest.fixture(autouse=True)
def zlib_only(monkeypatch):
    """``native_loader`` and ``utils.io`` decode and write through the zlib
    reader alone."""
    monkeypatch.setattr(nl, "ORDER", (nl.ZLIB,))


def _native(path, bits):
    load = nl.load_frames_native16 if bits == 16 else nl.load_frames_native
    return load([path])[0]


def _at(rgb, src_bits, bits):
    """Samples of ``src_bits`` to the reader's output at ``bits``."""
    rgb = np.asarray(rgb)
    if src_bits == 16:
        return rgb.astype(np.uint16) if bits == 16 else (
            rgb >> 8).astype(np.uint8)
    return rgb.astype(np.uint16) * 257 if bits == 16 else rgb.astype(np.uint8)


def _cv2_rgb(path, bits):
    a = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    a = np.repeat(a[..., None], 3, axis=2) if a.ndim == 2 else a[..., 2::-1]
    return _at(a, 16 if a.dtype == np.uint16 else 8, bits)


# ---- a PNG writer: any colour type and depth, a filter forced per row ----

SIG = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag, payload):
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload)))


def _pack_row(row, depth):
    v = row.reshape(-1).astype(np.uint32)
    if depth == 16:
        return v.astype(">u2").view(np.uint8)
    if depth == 8:
        return v.astype(np.uint8)
    bits = (v[:, None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(-1).astype(np.uint8))


def _filter_row(raw, prev, bpp, ftype):
    x, b = raw.astype(np.int64), prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 255).astype(np.uint8)


def write_png(path, samples, color, depth, filters=(0,), interlace=False,
              plte=None, trns=None, idat_parts=3):
    """``samples`` [H,W,C] at ``depth``; row k gets ``filters[k % len]``,
    rows counted across the Adam7 passes; the zlib stream split over
    ``idat_parts`` IDAT chunks, after an ancillary chunk."""
    h, w = samples.shape[:2]
    c = CHANNELS[color]
    samples = samples.reshape(h, w, c)
    bpp = max(1, c * depth // 8)
    raw, k = [], 0
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue  # an empty pass has no rows
        prev = np.zeros(len(_pack_row(sub[0], depth)), np.uint8)
        for row in sub:
            packed = _pack_row(row, depth)
            f = filters[k % len(filters)]
            k += 1
            raw.append(bytes([f]) + _filter_row(packed, prev, bpp, f).tobytes())
            prev = packed
    body = zlib.compress(b"".join(raw))
    cut = [len(body) * i // idat_parts for i in range(idat_parts + 1)]
    out = SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                            0, 0, int(interlace)))
    out += _chunk(b"tEXt", b"Comment\x00skipped")
    if plte is not None:
        out += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    for i in range(idat_parts):
        out += _chunk(b"IDAT", body[cut[i]:cut[i + 1]])
    out += _chunk(b"IEND", b"")
    path.write_bytes(out)
    return path


def _png_case(rng, color, depth, h=H, w=W):
    samples = rng.integers(0, 1 << depth, (h, w, CHANNELS[color]))
    plte = (rng.integers(0, 256, (1 << depth, 3)) if color == 3 else None)
    return samples, plte


def _png_expected(samples, color, depth, plte, bits):
    if color == 3:
        return _at(np.asarray(plte)[samples[..., 0]], 8, bits)
    v = samples[..., :1] if color in (0, 4) else samples[..., :3]
    v = np.repeat(v, 3, axis=2) if v.shape[2] == 1 else v
    if depth < 8:
        v = v * (255 // ((1 << depth) - 1))  # x255, x85, x17
    return _at(v, max(depth, 8), bits)


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "avg", "paeth"])
@pytest.mark.parametrize("color,depth", PNG_KINDS,
                         ids=[f"c{c}d{d}" for c, d in PNG_KINDS])
def test_png_matches_cv2(tmp_path, color, depth, ftype, interlace, bits):
    """Every colour type at every allowed depth, each row filter forced on
    every row, with and without Adam7, decoded at 8 and 16 bits."""
    rng = np.random.default_rng(1000 * color + 10 * depth + ftype)
    samples, plte = _png_case(rng, color, depth)
    path = write_png(tmp_path / "a.png", samples, color, depth, (ftype,),
                     interlace, plte)
    got = _native(path, bits)
    want = _png_expected(samples, color, depth, plte, bits)
    assert got.dtype == want.dtype and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _cv2_rgb(path, bits))
    # the JAX package's PIL route, where PIL keeps the depth
    if bits == 8:
        np.testing.assert_array_equal(
            got, jio.load_frames([path], use_native=False)[0])
    if depth <= 8 or color == 0:
        np.testing.assert_array_equal(
            got, _at(jio.load_frames([path], use_native=False,
                                     preserve_depth=True)[0], 16, bits))
        raw = jio.imread_unchanged(path)
        if raw.dtype == np.uint16:
            np.testing.assert_array_equal(got[..., 0], _at(raw, 16, bits))
        else:
            np.testing.assert_array_equal(got, _at(raw, 8, bits))


CV2_FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
               "sub": cv2.IMWRITE_PNG_FILTER_SUB,
               "up": cv2.IMWRITE_PNG_FILTER_UP,
               "avg": cv2.IMWRITE_PNG_FILTER_AVG,
               "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
               "all": cv2.IMWRITE_PNG_ALL_FILTERS}


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("ftype", list(CV2_FILTERS))
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_cv2_written_png(tmp_path, dtype, channels, ftype, bits):
    """cv2 (libpng) writes grey, RGB and RGBA at 8 and 16 bits with each
    filter; the reader gives back what was written."""
    rng = np.random.default_rng(channels * 7 + len(ftype))
    top = np.iinfo(dtype).max + 1
    rgba = rng.integers(0, top, (H, W, channels), dtype=dtype)
    path = tmp_path / "a.png"
    img = rgba[..., 0] if channels == 1 else rgba[..., [2, 1, 0, 3][:channels]]
    assert cv2.imwrite(str(path), img,
                       [cv2.IMWRITE_PNG_FILTER, CV2_FILTERS[ftype]])
    rgb = np.repeat(rgba[..., :1], 3, 2) if channels == 1 else rgba[..., :3]
    got = _native(path, bits)
    np.testing.assert_array_equal(got, _at(rgb, dtype().itemsize * 8, bits))
    np.testing.assert_array_equal(got, _cv2_rgb(path, bits))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("mode", ["1", "P1", "P2", "P4", "P8", "L", "LA",
                                  "RGBA"])
def test_pil_written_png(tmp_path, mode, bits):
    """PIL writes 1-bit grey and palettes of 1/2/4/8 bits (and a
    transparency chunk on the palette)."""
    rng = np.random.default_rng(len(mode) + ord(mode[-1]))
    path = tmp_path / "a.png"
    if mode == "1":
        im = Image.fromarray(rng.integers(0, 2, (H, W)).astype(bool))
        im.save(path)
    elif mode.startswith("P"):
        n = 1 << int(mode[1:])
        im = Image.fromarray(rng.integers(0, n, (H, W)).astype(np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes())
        im.save(path, bits=int(mode[1:]), transparency=0)
    else:
        shape = (H, W) if mode == "L" else (H, W, len(mode))
        im = Image.fromarray(rng.integers(0, 256, shape).astype(np.uint8),
                             mode)
        im.save(path)
    got = _native(path, bits)
    want = _at(np.asarray(Image.open(path).convert("RGB")), 8, bits)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _cv2_rgb(path, bits))
    np.testing.assert_array_equal(got, _at(jio.imread_rgb(path), 8, bits))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("color,depth", [(0, 2), (0, 16), (2, 8), (2, 16),
                                         (3, 4), (4, 16), (6, 8)])
@pytest.mark.parametrize("hw", [(1, 1), (1, 9), (9, 1), (2, 3), (3, 5),
                                (5, 2), (8, 8), (9, 17)])
def test_adam7_small_and_mixed_filters(tmp_path, hw, color, depth, bits):
    """Images so small that Adam7 passes are empty (no filter bytes), and
    all five filters in turn along the rows of every pass."""
    rng = np.random.default_rng(hw[0] * 31 + hw[1] + depth)
    samples, plte = _png_case(rng, color, depth, *hw)
    path = write_png(tmp_path / "a.png", samples, color, depth,
                     (4, 3, 1, 0, 2), True, plte, idat_parts=2)
    got = _native(path, bits)
    np.testing.assert_array_equal(
        got, _png_expected(samples, color, depth, plte, bits))
    np.testing.assert_array_equal(got, _cv2_rgb(path, bits))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("color,depth,trns", [
    (0, 8, b"\x00\x07"), (0, 16, b"\x12\x34"), (0, 4, b"\x00\x03"),
    (2, 8, b"\x00\x01\x00\x02\x00\x03"), (2, 16, b"\x01\x02\x03\x04\x05\x06"),
    (3, 8, b"\x00\x80\xff"), (3, 2, b"\x10"),
])
def test_trns_dropped(tmp_path, color, depth, trns, bits):
    """tRNS is dropped, not composited (png_set_tRNS_to_alpha, then
    png_set_strip_alpha)."""
    rng = np.random.default_rng(depth + len(trns))
    samples, plte = _png_case(rng, color, depth)
    path = write_png(tmp_path / "a.png", samples, color, depth, (1, 4),
                     False, plte, trns)
    got = _native(path, bits)
    np.testing.assert_array_equal(
        got, _png_expected(samples, color, depth, plte, bits))
    np.testing.assert_array_equal(got, _cv2_rgb(path, bits))


# ---- TIFF ----------------------------------------------------------------

def _tiff_samples(rng, dtype, channels, h=H, w=W):
    top = np.iinfo(dtype).max + 1
    return rng.integers(0, top, (h, w, channels), dtype=dtype)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("rows", [1, 7, None], ids=["rps1", "rps7", "rpsall"])
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("compression", [1, 5, 8, 32773],
                         ids=["none", "lzw", "deflate", "packbits"])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16],
                         ids=["u8", "u16"])
def test_tiff_matches_cv2(tmp_path, dtype, channels, compression, predictor,
                          rows, bits):
    """cv2 (libtiff) writes 8/16 bits x 1/3/4 samples x each compression x
    predictor 1/2 x 1, 7 or all rows a strip."""
    rng = np.random.default_rng(channels * 100 + compression % 97 + predictor)
    s = _tiff_samples(rng, dtype, channels)
    path = tmp_path / "a.tif"
    img = s[..., 0] if channels == 1 else s[..., [2, 1, 0, 3][:channels]]
    params = [cv2.IMWRITE_TIFF_COMPRESSION, compression,
              cv2.IMWRITE_TIFF_PREDICTOR, predictor]
    if rows:
        params += [cv2.IMWRITE_TIFF_ROWSPERSTRIP, rows]
    assert cv2.imwrite(str(path), img, params)
    rgb = np.repeat(s[..., :1], 3, 2) if channels == 1 else s[..., :3]
    got = _native(path, bits)
    np.testing.assert_array_equal(got, _at(rgb, dtype().itemsize * 8, bits))
    np.testing.assert_array_equal(got, _cv2_rgb(path, bits))
    assert nl.probe(path) == (H, W)


def write_tiff(path, samples, order="<", compression=1, predictor=1,
               rows_per_strip=None, extra=(), encode=None):
    """A baseline TIFF by hand: [H,W,C] uint8/uint16 samples, byte order
    ``order`` ('<' II, '>' MM), compression 1 or 8 (Deflate; the
    horizontal predictor applied only there, as libtiff applies it), or
    any other whose strips ``encode`` makes."""
    h, w, c = samples.shape
    bits = samples.dtype.itemsize * 8
    rps = rows_per_strip or h
    strips = []
    for y0 in range(0, h, rps):
        s = samples[y0:y0 + rps].astype(np.int64)
        if predictor == 2 and compression == 8:
            s[:, 1:] = (s[:, 1:] - s[:, :-1]) & ((1 << bits) - 1)
        raw = s.astype(np.dtype(f"{order}u{bits // 8}")).tobytes()
        strips.append(encode(raw) if encode else
                      zlib.compress(raw) if compression == 8 else raw)
    offsets, pos = [], 8
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    tags = sorted([(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * c),
                   (259, 3, [compression]), (262, 3, [1 if c == 1 else 2]),
                   (273, 4, offsets), (277, 3, [c]), (278, 4, [rps]),
                   (279, 4, [len(s) for s in strips]), (284, 3, [1]),
                   (317, 3, [predictor])] + list(extra))
    out_of_line, entries = b"", []
    base = pos
    for tag, typ, vals in tags:
        packed = struct.pack(order + ("H" if typ == 3 else "I") * len(vals),
                             *vals)
        head = struct.pack(order + "HHI", tag, typ, len(vals))
        if len(packed) <= 4:
            entries.append(head + packed.ljust(4, b"\0"))
        else:
            entries.append(head + struct.pack(order + "I",
                                              base + len(out_of_line)))
            out_of_line += packed + b"\0" * (len(packed) % 2)
    ifd = base + len(out_of_line)
    path.write_bytes(
        (b"II*\0" if order == "<" else b"MM\0*") + struct.pack(order + "I", ifd)
        + b"".join(strips) + out_of_line
        + struct.pack(order + "H", len(entries)) + b"".join(entries)
        + b"\0\0\0\0")
    return path


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("rows", [4, 1000])
@pytest.mark.parametrize("compression,predictor", [(1, 1), (8, 1), (8, 2)])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["u8", "u16"])
def test_hand_built_tiff(tmp_path, dtype, order, compression, predictor,
                         rows, bits):
    """Both byte orders (the predictor on 16-bit samples works at 16 bits in
    the file's order) and RowsPerStrip beyond the image's height."""
    rng = np.random.default_rng(rows + compression + predictor)
    s = _tiff_samples(rng, dtype, 3)
    path = write_tiff(tmp_path / "a.tif", s, order, compression, predictor,
                      rows)
    got = _native(path, bits)
    np.testing.assert_array_equal(got, _at(s, dtype().itemsize * 8, bits))
    np.testing.assert_array_equal(got, _cv2_rgb(path, bits))


def _lzw_lsb_first(data: bytes) -> bytes:
    """Old-style TIFF LZW: ClearCode, every byte a literal, EOI, 9-bit
    codes packed least significant bit first."""
    acc, nbits, out = 0, 0, bytearray()
    for code in [256, *data, 257]:
        acc |= code << nbits
        nbits += 9
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def test_old_style_lzw_goes_to_pil(tmp_path):
    """The reader refuses LSB-first LZW (status ERR_FORMAT) rather than
    decode it wrongly; ``load_frames`` then decodes it through PIL."""
    s = _tiff_samples(np.random.default_rng(3), np.uint8, 3, 5, 7)
    path = write_tiff(tmp_path / "a.tif", s, compression=5,
                      encode=_lzw_lsb_first)
    _, statuses = nl.decode_batch([path], 5, 7, np.uint8)
    assert statuses == [nl.ERR_FORMAT]
    got = pio.load_frames([path])[0]
    np.testing.assert_array_equal(got, s)
    np.testing.assert_array_equal(got, pio.imread_rgb(path))


# ---- routes, errors, threads, the writer ----------------------------------

def _tiled16(path, rgb16):
    """A 16-bit RGB TIFF in one 16x16 tile: outside the reader's subset,
    and PIL reduces it to 8 bits."""
    h, w, _ = rgb16.shape
    tile = np.zeros((16, 16, 3), np.uint16)
    tile[:h, :w] = rgb16
    body = tile.astype("<u2").tobytes()
    base = 8 + len(body)
    tags = [(256, 4, w), (257, 4, h), (258, 3, base), (259, 3, 1),
            (262, 3, 2), (277, 3, 3), (284, 3, 1), (322, 4, 16),
            (323, 4, 16), (324, 4, 8), (325, 4, len(body))]
    ents = b"".join(
        struct.pack("<HHII", t, typ, 3, v) if t == 258 else
        struct.pack("<HHI", t, typ, 1)
        + struct.pack("<I" if typ == 4 else "<H", v).ljust(4, b"\0")
        for t, typ, v in tags)
    path.write_bytes(b"II*\0" + struct.pack("<I", base + 8) + body
                     + struct.pack("<HHHH", 16, 16, 16, 0)
                     + struct.pack("<H", len(tags)) + ents + b"\0\0\0\0")
    return path


@pytest.fixture
def mixed(tmp_path):
    """A PNG, a JPEG, a JPEG-compressed TIFF and a tiled 16-bit TIFF of one
    size: the reader takes the PNG only."""
    rng = np.random.default_rng(17)
    rgb = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    out = {}
    out["png"] = tmp_path / "a.png"
    out["jpeg"] = tmp_path / "b.jpg"
    out["tiff_jpeg"] = tmp_path / "c.tif"
    for k, params in (("png", []), ("jpeg", []),
                      ("tiff_jpeg", [cv2.IMWRITE_TIFF_COMPRESSION, 7])):
        assert cv2.imwrite(str(out[k]), rgb[..., ::-1], params)
    out["tiled16"] = _tiled16(tmp_path / "d.tif", rng.integers(
        0, 65536, (9, 11, 3), dtype=np.uint16))
    return out


@pytest.mark.parametrize("order", [("png", "jpeg", "tiff_jpeg", "tiled16"),
                                   ("jpeg", "png", "tiled16"),
                                   ("tiled16", "tiff_jpeg")])
def test_files_not_taken_decode_through_pil(mixed, order):
    """JPEG and TIFF outside the subset get ERR_FORMAT and decode through
    the PIL route, beside the files the reader takes, frame 0 too."""
    files = [mixed[k] for k in order]
    _, statuses = nl.decode_batch(files, 9, 11, np.uint8)
    assert statuses == [0 if k == "png" else nl.ERR_FORMAT for k in order]
    got = pio.load_frames(files)
    np.testing.assert_array_equal(got, np.stack([pio.imread_rgb(f)
                                                 for f in files]))
    np.testing.assert_array_equal(got, jio.load_frames(files,
                                                       use_native=False))
    if "tiled16" not in order:
        np.testing.assert_array_equal(
            pio.load_frames(files, preserve_depth=True),
            got.astype(np.uint16) * 257)
    assert nl.probe_status(mixed["jpeg"])[0] == nl.ERR_FORMAT


def test_16bit_tiff_outside_subset_refused_at_depth(mixed):
    """A 16-bit TIFF the reader does not take goes to PIL, which would
    reduce it to 8 bits: refused at full depth, as without a reader."""
    with pytest.raises(errors.StackerIoError) as e:
        pio.load_frames([mixed["png"], mixed["tiled16"]], preserve_depth=True)
    assert str(mixed["tiled16"]) in str(e.value)
    assert "16-bit samples" in str(e.value)


def _broken(tmp_path, how):
    rng = np.random.default_rng(5)
    samples, _ = _png_case(rng, 2, 16, 16, 20)
    path = write_png(tmp_path / f"{how}.png", samples, 2, 16, (4,),
                     idat_parts=4)
    data = bytearray(path.read_bytes())
    if how == "truncated":
        del data[len(data) * 3 // 5:]
    elif how == "idat_crc":
        at = data.index(b"IDAT")
        n = struct.unpack(">I", data[at - 4:at])[0]
        data[at + 4 + n] ^= 0xFF
    elif how == "critical":  # an unknown critical chunk before IDAT
        at = data.index(b"IDAT") - 4
        data[at:at] = _chunk(b"ABCD", b"x")
    elif how == "filter":  # filter type 5 on the first row
        rows = zlib.decompress(b"".join(_idat(bytes(data))))
        data = bytearray(data[:33] + _chunk(b"IDAT", zlib.compress(
            b"\x05" + rows[1:])) + _chunk(b"IEND", b""))
    path.write_bytes(bytes(data))
    return path


def _idat(data):
    pos, out = 8, []
    while pos + 8 <= len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == b"IDAT":
            out.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    return out


def _outcome(load, files, **kw):
    """The frames ``load`` decodes, or the message of the StackerIoError it
    raises."""
    try:
        return load(files, **kw)
    except (errors.StackerIoError, J.StackerIoError) as e:
        return str(e)


def _same_as_reference(files, preserve_depth):
    """``utils.io.load_frames`` gives what the JAX package's gives: frames
    bitwise, or a StackerIoError with the same message.  The reference's
    native route falls back to this PIL route for the whole burst when one
    file fails; without its library it is this route."""
    got = _outcome(pio.load_frames, files, preserve_depth=preserve_depth)
    want = _outcome(jio.load_frames, files, use_native=False,
                    preserve_depth=preserve_depth)
    assert type(got) is type(want), (got, want)
    if isinstance(got, str):
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("how", ["truncated", "idat_crc", "critical",
                                 "filter"])
@pytest.mark.parametrize("preserve_depth", [False, True])
def test_broken_png_names_the_file(tmp_path, how, preserve_depth):
    """The reader refuses a broken PNG (ERR_DECODE) and its own batch
    loader raises naming every such file; ``utils.io`` then sends the file
    to the PIL route, as the JAX package does, and gives what it gives
    (PIL skips CRCs and unknown chunks, and raises on the rest)."""
    rng = np.random.default_rng(4)
    good = write_png(tmp_path / "good.png", _png_case(rng, 2, 8, 16, 20)[0],
                     2, 8)
    bad = _broken(tmp_path, how)
    _, statuses = nl.decode_batch([good, bad], 16, 20, np.uint16)
    assert statuses == [0, nl.ERR_DECODE]
    load = nl.load_frames_native16 if preserve_depth else nl.load_frames_native
    with pytest.raises(errors.StackerIoError) as e:
        load([good, bad, bad])
    msg = str(e.value)
    assert msg.startswith("decode failures: ")
    assert msg.count(f"{bad} (code 2)") == 2 and str(good) not in msg
    for files in ([good, bad], [bad, good]):
        got = _same_as_reference(files, preserve_depth)
        if isinstance(got, str):
            assert str(bad) in got


def _refused(tmp_path, case):
    """A file that one of the two libraries does not decode: a CMYK JPEG
    (libjpeg gives no RGB for it, the zlib reader takes no JPEG), a PNG
    named .jpg and a JPEG named .png (the full loader picks its decoder by
    the name, the zlib reader by the first bytes)."""
    rng = np.random.default_rng(16)
    path = tmp_path / {"cmyk_jpeg": "c.jpg", "png_named_jpg": "p.jpg",
                       "jpeg_named_png": "j.png"}[case]
    if case == "cmyk_jpeg":
        Image.fromarray(rng.integers(0, 256, (16, 20, 4), dtype=np.uint8),
                        "CMYK").save(path, format="JPEG")
    else:
        rgb = rng.integers(0, 256, (16, 20, 3), dtype=np.uint8)
        ok, buf = cv2.imencode(".png" if case == "png_named_jpg" else ".jpg",
                               rgb)
        assert ok
        path.write_bytes(buf.tobytes())
    return path


@pytest.mark.parametrize("bad_first", [False, True],
                         ids=["bad_second", "bad_first"])
@pytest.mark.parametrize("preserve_depth", [False, True])
@pytest.mark.parametrize("case", ["cmyk_jpeg", "png_named_jpg",
                                  "jpeg_named_png"])
@pytest.mark.parametrize("backend", [nl.FULL, nl.ZLIB])
def test_refused_files_match_reference(tmp_path, monkeypatch, backend, case,
                                       preserve_depth, bad_first):
    """Under either library, a file it does not decode goes to the PIL
    route, frame 0 too, and the burst loads as the JAX package loads it."""
    if nl.library(backend) is None:
        pytest.skip(f"{backend} does not build here: "
                    f"{nl._errors.get(backend)}")
    monkeypatch.setattr(nl, "ORDER", (backend,))
    good = write_png(tmp_path / "good.png", _png_case(
        np.random.default_rng(18), 2, 8, 16, 20)[0], 2, 8)
    bad = _refused(tmp_path, case)
    files = [bad, good] if bad_first else [good, bad]
    got = _same_as_reference(files, preserve_depth)
    assert not isinstance(got, str) and got.shape == (2, 16, 20, 3)


def test_files_not_taken_decode_on_a_pool(tmp_path, monkeypatch):
    """The files the reader gives ERR_FORMAT decode through the PIL route
    on a thread pool of ``num_threads``."""
    rng = np.random.default_rng(19)
    files = []
    for i in range(8):
        files.append(tmp_path / f"{i}.jpg")
        assert cv2.imwrite(str(files[-1]),
                           rng.integers(0, 256, (9, 11, 3), dtype=np.uint8))
    threads = set()
    orig = pio.imread_rgb

    def recorded(path):
        threads.add(threading.get_ident())
        time.sleep(0.05)
        return orig(path)

    monkeypatch.setattr(pio, "imread_rgb", recorded)
    got = pio.load_frames(files, num_threads=4)
    assert 1 < len(threads) <= 4
    monkeypatch.setattr(pio, "imread_rgb", orig)
    np.testing.assert_array_equal(got, jio.load_frames(files,
                                                       use_native=False))


@pytest.mark.parametrize("preserve_depth", [False, True])
def test_size_mismatch_matches_reference(tmp_path, preserve_depth):
    """A frame of another size raises the PIL route's message, also for a
    file the reader does not take."""
    rng = np.random.default_rng(6)
    a = write_png(tmp_path / "a.png", _png_case(rng, 2, 8, 9, 11)[0], 2, 8)
    b = write_png(tmp_path / "b.png", _png_case(rng, 0, 16, 5, 7)[0], 0, 16)
    c = tmp_path / "c.jpg"
    assert cv2.imwrite(str(c), np.zeros((6, 4, 3), np.uint8))
    for pair in ([a, b], [a, c], [c, a]):
        with pytest.raises(errors.StackerIoError) as e_port:
            pio.load_frames(pair, preserve_depth=preserve_depth)
        with pytest.raises(J.StackerIoError) as e_ref:
            jio.load_frames(pair, use_native=False,
                            preserve_depth=preserve_depth)
        assert str(e_port.value) == str(e_ref.value)
        assert "frame size mismatch" in str(e_port.value)


def test_missing_file_and_probe(tmp_path):
    rng = np.random.default_rng(8)
    a = write_png(tmp_path / "a.png", _png_case(rng, 6, 8, 9, 11)[0], 6, 8)
    assert nl.probe(a) == (9, 11)
    missing = tmp_path / "nope.png"
    _, statuses = nl.decode_batch([a, missing], 9, 11, np.uint8)
    assert statuses == [0, nl.ERR_OPEN]
    for files in ([a, missing], [missing, a]):
        with pytest.raises(errors.StackerIoError, match="nope.png") as e:
            pio.load_frames(files)
        with pytest.raises(J.StackerIoError) as e_ref:
            jio.load_frames(files, use_native=False)
        assert str(e.value) == str(e_ref.value)
    with pytest.raises(errors.StackerIoError, match="probe failed"):
        nl.probe(missing)


@pytest.mark.parametrize("bits", [8, 16])
def test_threads_bitwise(tmp_path, bits):
    """``num_threads`` 1 and 8 give the same frames over 16 files of every
    kind the reader takes."""
    rng = np.random.default_rng(9)
    files, want = [], []
    kinds = PNG_KINDS[:8]
    for i in range(16):
        if i % 2:
            color, depth = kinds[i // 2]
            samples, plte = _png_case(rng, color, depth)
            files.append(write_png(tmp_path / f"{i}.png", samples, color,
                                   depth, (i % 5,), i % 4 == 1, plte))
            want.append(_png_expected(samples, color, depth, plte, bits))
        else:
            dtype = (np.uint8, np.uint16)[i % 4 // 2]
            s = _tiff_samples(rng, dtype, 3)
            files.append(write_tiff(tmp_path / f"{i}.tif", s, "<>"[i % 8 // 4],
                                    (1, 8)[i % 3 > 0], 2, 5))
            want.append(_at(s, dtype().itemsize * 8, bits))
    load = nl.load_frames_native16 if bits == 16 else nl.load_frames_native
    one = load(files, num_threads=1)
    eight = load(files, num_threads=8)
    np.testing.assert_array_equal(one, eight)
    np.testing.assert_array_equal(one, np.stack(want))


@pytest.mark.parametrize("img", ["uint16", "float", "uint8", "grey16"])
def test_save_image_16bit_through_reader(tmp_path, monkeypatch, img):
    """``save_image(bit_depth=16)`` writes through the zlib library (the
    pure-Python encoder is not reached) and reads back bitwise through
    cv2, the same image as the JAX package's writer gives."""
    rng = np.random.default_rng(10)
    arr = {"uint16": rng.integers(0, 65536, (21, 17, 3), dtype=np.uint16),
           "float": rng.random((21, 17, 3), dtype=np.float32),
           "uint8": rng.integers(0, 256, (21, 17, 3), dtype=np.uint8),
           "grey16": rng.integers(0, 65536, (21, 17), dtype=np.uint16)}[img]

    def unreached(*a):
        raise AssertionError("pure-Python encoder used")

    monkeypatch.setattr(pio, "_write_png16_py", unreached)
    pio.save_image(tmp_path / "p.png", arr, bit_depth=16)
    jio.save_image(tmp_path / "j.png", arr, bit_depth=16)
    got = cv2.imread(str(tmp_path / "p.png"), cv2.IMREAD_UNCHANGED)
    want = cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED)
    assert got.dtype == np.uint16 and got.shape == (21, 17, 3)
    np.testing.assert_array_equal(got, want)
    if img == "uint16":
        np.testing.assert_array_equal(got[..., ::-1], arr)
    np.testing.assert_array_equal(
        pio.load_frames([tmp_path / "p.png"], preserve_depth=True)[0],
        got[..., ::-1])


def test_write_png16_large_rows(tmp_path):
    """Rows wider than the writer's 1 MiB IDAT buffer, one chunk of zlib
    output spread over several IDAT chunks."""
    rgb16 = np.random.default_rng(11).integers(
        0, 65536, (3, 70000, 3), dtype=np.uint16)
    path = tmp_path / "wide.png"
    nl.write_png16_native(path, rgb16)
    assert len(_idat(path.read_bytes())) > 1
    np.testing.assert_array_equal(
        cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., ::-1], rgb16)
    np.testing.assert_array_equal(_native(path, 16), rgb16)


def test_rgb_to_gray(reader):
    rgb = np.random.default_rng(12).integers(0, 256, (31, 29, 3),
                                             dtype=np.uint8)
    np.testing.assert_array_equal(
        nl.rgb_to_gray_native(rgb, 3),
        pio.rgb_to_gray_u8_host(rgb))


def test_backend_and_build_errors(tmp_path, monkeypatch):
    """Neither library builds: ``backend()`` is None, ``build_error()``
    gives both reasons, and ``utils.io`` decodes through PIL (a 48-bit PNG
    refused at full depth, as the JAX package refuses it)."""
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    specs = dict(nl._SPECS)
    specs[nl.FULL] = specs[nl.FULL]._replace(source=tmp_path / "absent.cpp")
    specs[nl.ZLIB] = specs[nl.ZLIB]._replace(source=broken)
    monkeypatch.setattr(nl, "_SPECS", specs)
    monkeypatch.setattr(nl, "ORDER", (nl.FULL, nl.ZLIB))
    monkeypatch.setattr(nl, "_libs", {})
    monkeypatch.setattr(nl, "_errors", {})
    assert nl.backend() is None and not nl.available()
    err = nl.build_error()
    assert f"{nl.FULL}: " in err and "absent.cpp not found" in err
    assert f"{nl.ZLIB}: " in err and "failed for" in err
    rgb16 = np.random.default_rng(13).integers(0, 65536, (9, 11, 3),
                                               dtype=np.uint16)
    path = tmp_path / "a.png"
    pio.save_image(path, rgb16, bit_depth=16)  # the pure-Python encoder
    np.testing.assert_array_equal(pio.load_frames([path])[0],
                                  (rgb16 >> 8).astype(np.uint8))
    with pytest.raises(errors.StackerIoError, match="16-bit samples"):
        pio.load_frames([path], preserve_depth=True)


def test_backend_order(monkeypatch):
    monkeypatch.setattr(nl, "ORDER", (nl.ZLIB,))
    assert nl.backend() == nl.ZLIB and nl.build_error() is None
    monkeypatch.setattr(nl, "ORDER", (nl.FULL, nl.ZLIB))
    assert nl.backend() in (nl.FULL, nl.ZLIB)


# ---- the file entry points on 48-bit files ---------------------------------

def _ecc_params(mod):
    return mod.EccMatchParameters(
        motion_type=mod.MotionType.Homography, max_count=50, epsilon=1e-4,
        gauss_filt_size=5, coarse_levels=1)


@pytest.fixture(scope="module")
def rgb16_burst():
    frames = burst(21, 4, 192, 256, max_shift=4.0, max_angle=0.4)[0]
    low = np.random.default_rng(14).integers(0, 256, frames.shape,
                                             dtype=np.uint16)
    rgb16 = frames.astype(np.uint16) << 8 | low
    return rgb16, J.ecc_match_arrays(rgb16, _ecc_params(J))


@pytest.mark.parametrize("fmt", ["png", "tiff"])
def test_ecc_match_16bit_files(tmp_path, rgb16_burst, fmt):
    rgb16, want = rgb16_burst
    paths = []
    for i, f in enumerate(rgb16):
        paths.append(tmp_path / f"f{i}.{'png' if fmt == 'png' else 'tif'}")
        params = ([cv2.IMWRITE_TIFF_COMPRESSION, 8,
                   cv2.IMWRITE_TIFF_PREDICTOR, 2] if fmt == "tiff" else [])
        assert cv2.imwrite(str(paths[-1]), f[..., ::-1], params)
    np.testing.assert_array_equal(
        pio.load_frames(paths, preserve_depth=True), rgb16)
    got = P.ecc_match(paths, _ecc_params(P), preserve_depth=True,
                      device="cpu")
    np.testing.assert_array_equal(
        got, P.ecc_match_arrays(rgb16, _ecc_params(P), device="cpu"))
    assert got.shape == want.shape == rgb16.shape[1:]
    assert np.abs(got[8:-8, 8:-8] - want[8:-8, 8:-8]).max() < 0.02


def test_pil_png_encoder_output(tmp_path):
    """A PNG from PIL's own encoder (its adaptive filters) decodes
    bitwise."""
    rgb = np.random.default_rng(15).integers(0, 256, (H, W, 3),
                                             dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG", compress_level=1)
    path = tmp_path / "a.png"
    path.write_bytes(buf.getvalue())
    np.testing.assert_array_equal(_native(path, 8), rgb)
