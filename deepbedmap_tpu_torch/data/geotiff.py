"""GeoTIFF reader/writer — the framework's GDAL replacement.

Counterpart of ``deepbedmap_tpu/data/geotiff.py``, copied because importing
the JAX package loads JAX; the two write the same bytes. They differ in the
docstrings and in the codec: the JAX copy falls back to pure-Python LZW when
its native codec is missing, this one calls the native codec always. The
reference writes its DEMs through rasterio/GDAL with LZW + tiling + BigTIFF
(data_prep.py:809-824, deepbedmap.py:749-756). The port carries its own codec:

- read: classic TIFF and BigTIFF, strips or tiles, uncompressed or LZW
  (+ horizontal predictor), u8/i16/u16/i32/f32/f64 single-band;
- write: classic or BigTIFF, striped or square-tiled, optional LZW, GeoTIFF
  georeferencing (ModelPixelScale + ModelTiepoint + EPSG geokeys) and
  GDAL_NODATA;
- the LZW inner loops run in the native C++ codec (``native/tiffcodec.cc``,
  built by g++ on first use, ``data._tiffnative``); if it cannot be built
  they raise. ``_lzw_encode_py`` / ``_lzw_decode_py`` are the plain versions
  the tests hold the native codec against; nothing else calls them.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

from deepbedmap_tpu_torch.data import _tiffnative

# TIFF tag ids
_T_SUBFILETYPE = 254  # NewSubfileType: 1 = reduced-resolution (overview) page
_T_WIDTH, _T_HEIGHT = 256, 257
_T_BITS, _T_COMPRESSION, _T_PHOTOMETRIC = 258, 259, 262
_T_STRIP_OFFSETS, _T_SAMPLES, _T_ROWS_PER_STRIP, _T_STRIP_COUNTS = 273, 277, 278, 279
_T_PREDICTOR = 317
_T_TILE_W, _T_TILE_H, _T_TILE_OFFSETS, _T_TILE_COUNTS = 322, 323, 324, 325
_T_SAMPLE_FORMAT = 339
_T_PIXEL_SCALE, _T_TIEPOINT = 33550, 33922
_T_GEO_KEYS, _T_GEO_DOUBLES, _T_GEO_ASCII = 34735, 34736, 34737
_T_GDAL_NODATA = 42113

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8, 17: 8}
_TYPE_FMT = {3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q"}


# --------------------------------------------------------------------------
# LZW (TIFF flavour: MSB-first bits, 9..12-bit codes, early change)
# --------------------------------------------------------------------------

def lzw_decode(data: bytes) -> bytes:
    return _tiffnative.lzw_decode(data)


def lzw_encode(data: bytes) -> bytes:
    return _tiffnative.lzw_encode(data)


def _lzw_decode_py(data: bytes) -> bytes:
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: list = []

    def reset():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset()
    bitbuf = 0
    bitcnt = 0
    width = 9
    prev: Optional[bytes] = None
    pos = 0
    n = len(data)
    while pos < n or bitcnt >= width:
        while bitcnt < width and pos < n:
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            bitcnt += 8
        if bitcnt < width:
            break
        code = (bitbuf >> (bitcnt - width)) & ((1 << width) - 1)
        bitcnt -= width
        if code == CLEAR:
            reset()
            width = 9
            prev = None
            continue
        if code == EOI:
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:  # KwKwK case
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # TIFF 'early change' (libtiff-compatible): bump width one code early
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def _lzw_encode_py(data: bytes) -> bytes:
    CLEAR, EOI = 256, 257
    out = bytearray()
    bitbuf = 0
    bitcnt = 0

    def put(code: int, width: int):
        nonlocal bitbuf, bitcnt
        bitbuf = (bitbuf << width) | code
        bitcnt += width
        while bitcnt >= 8:
            out.append((bitbuf >> (bitcnt - 8)) & 0xFF)
            bitcnt -= 8

    table: Dict[bytes, int] = {bytes([i]): i for i in range(256)}
    next_code = 258
    width = 9
    put(CLEAR, width)
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = next_code
        next_code += 1
        # width transition mirroring libtiff's decoder (which applies the
        # spec's 'early change' on its side): the encoder bumps once its next
        # free entry fills the current width, i.e. the decoder — whose table
        # trails by one entry — just crossed (1<<width)-1
        if next_code == (1 << width) and width < 12:
            width += 1
        elif next_code == (1 << 12) - 2:
            put(CLEAR, width)
            table = {bytes([i]): i for i in range(256)}
            next_code = 258
            width = 9
        w = bytes([byte])
    if w:
        put(table[w], width)
    put(EOI, width)
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------

def _parse_tiff_header(raw8: bytes):
    """TIFF/BigTIFF header -> (byte order, magic, layout sizes dict)."""
    byte0 = raw8[:2]
    assert byte0 in (b"II", b"MM"), "not a TIFF"
    bo = "<" if byte0 == b"II" else ">"
    magic = struct.unpack(bo + "H", raw8[2:4])[0]
    if magic == 42:
        lay = dict(entry_size=12, count_fmt="H", count_size=2,
                   off_fmt="I", ptr_size=4, inline=4, first_ifd_at=4)
    elif magic == 43:
        lay = dict(entry_size=20, count_fmt="Q", count_size=8,
                   off_fmt="Q", ptr_size=8, inline=8, first_ifd_at=8)
    else:
        raise ValueError(f"bad TIFF magic {magic}")
    return bo, magic, lay


def _read_ifd_tags(f, page: int):
    """Seek-based IFD parse (reads only the header, the IFD chain up to
    ``page``, and that page's out-of-line tag payloads — not the raster
    bytes). Returns (bo, tags dict)."""
    f.seek(0)
    head = f.read(16)
    bo, magic, lay = _parse_tiff_header(head)
    f.seek(lay["first_ifd_at"])
    ifd_off = struct.unpack(
        bo + lay["off_fmt"], f.read(lay["ptr_size"])
    )[0]
    for _ in range(page):
        f.seek(ifd_off)
        (n,) = struct.unpack(bo + lay["count_fmt"], f.read(lay["count_size"]))
        f.seek(ifd_off + lay["count_size"] + n * lay["entry_size"])
        ifd_off = struct.unpack(bo + lay["off_fmt"], f.read(lay["ptr_size"]))[0]
        if ifd_off == 0:
            raise ValueError(f"TIFF has no page {page}")
    f.seek(ifd_off)
    (n_entries,) = struct.unpack(
        bo + lay["count_fmt"], f.read(lay["count_size"])
    )
    entries_raw = f.read(n_entries * lay["entry_size"])
    off_bytes = 4 if magic == 42 else 8
    tags: Dict[int, np.ndarray] = {}
    deferred = []
    for i in range(n_entries):
        e = entries_raw[i * lay["entry_size"] : (i + 1) * lay["entry_size"]]
        tag, typ = struct.unpack(bo + "HH", e[:4])
        cnt = struct.unpack(bo + lay["off_fmt"], e[4 : 4 + off_bytes])[0]
        size = _TYPE_SIZES.get(typ, 1) * cnt
        val_field = e[4 + off_bytes :]
        if size <= lay["inline"]:
            payload = val_field[:size]
            tags[tag] = _tag_payload(payload, typ, cnt, bo)
        else:
            off = struct.unpack(bo + lay["off_fmt"], val_field)[0]
            deferred.append((tag, typ, cnt, off, size))
    for tag, typ, cnt, off, size in deferred:
        f.seek(off)
        tags[tag] = _tag_payload(f.read(size), typ, cnt, bo)
    return bo, tags


def _tag_payload(payload: bytes, typ: int, cnt: int, bo: str):
    if typ in _TYPE_FMT:
        return np.frombuffer(
            payload, dtype=np.dtype(bo + _TYPE_FMT[typ]), count=cnt
        )
    if typ == 2:  # ascii
        return payload
    return np.frombuffer(payload, dtype=np.uint8)


def _tiff_dtype(tags, bo: str) -> np.dtype:
    bits = int(tags.get(_T_BITS, np.array([1]))[0])
    sample_format = int(tags.get(_T_SAMPLE_FORMAT, np.array([1]))[0])
    samples = int(tags.get(_T_SAMPLES, np.array([1]))[0])
    assert samples == 1, "single-band only"
    dtype = {
        (1, 8): np.uint8,
        (1, 16): np.uint16,
        (1, 32): np.uint32,
        (2, 8): np.int8,
        (2, 16): np.int16,
        (2, 32): np.int32,
        (3, 32): np.float32,
        (3, 64): np.float64,
    }[(sample_format, bits)]
    return np.dtype(dtype).newbyteorder(bo)


def _tiff_meta(tags) -> dict:
    meta = {"left": None, "top": None, "res": None, "nodata": None,
            "crs_epsg": None}
    if _T_PIXEL_SCALE in tags and _T_TIEPOINT in tags:
        scale = tags[_T_PIXEL_SCALE]
        tie = tags[_T_TIEPOINT]
        meta["res"] = float(scale[0])
        meta["left"] = float(tie[3] - tie[0] * scale[0])
        meta["top"] = float(tie[4] + tie[1] * scale[1])
    if _T_GDAL_NODATA in tags:
        try:
            meta["nodata"] = float(tags[_T_GDAL_NODATA].split(b"\x00")[0])
        except ValueError:
            pass
    if _T_GEO_KEYS in tags:
        keys = tags[_T_GEO_KEYS]
        for k in range(4, len(keys), 4):
            if keys[k] == 3072:  # ProjectedCSTypeGeoKey
                meta["crs_epsg"] = int(keys[k + 3])
    return meta


def read_geotiff_meta(path: str, page: int = 0) -> dict:
    """Geo metadata + shape/dtype of one TIFF page without decoding any
    raster bytes (header + IFD seeks only)."""
    with open(path, "rb") as f:
        bo, tags = _read_ifd_tags(f, page)
    meta = _tiff_meta(tags)
    meta["height"] = int(tags[_T_HEIGHT][0])
    meta["width"] = int(tags[_T_WIDTH][0])
    meta["dtype"] = _tiff_dtype(tags, bo).newbyteorder("=")
    return meta


def read_geotiff_window(
    path: str,
    rows: Tuple[int, int],
    cols: Optional[Tuple[int, int]] = None,
    page: int = 0,
):
    """Read only the pixel window ``rows=(r0, r1), cols=(c0, c1)`` (half-open,
    clipped to the raster) of a single-band GeoTIFF — seeks to and decodes
    ONLY the intersecting strips (or tiles), never the whole raster.
    Returns (array, meta) with ``left``/``top`` shifted to the window origin.
    The reference reads crops through rasterio/GDAL windowed IO
    (deepbedmap.py:381-447); this is the same contract on our own codec."""
    with open(path, "rb") as f:
        bo, tags = _read_ifd_tags(f, page)
        width = int(tags[_T_WIDTH][0])
        height = int(tags[_T_HEIGHT][0])
        compression = int(tags.get(_T_COMPRESSION, np.array([1]))[0])
        predictor = int(tags.get(_T_PREDICTOR, np.array([1]))[0])
        assert compression in (1, 5), f"unsupported compression {compression}"
        dt = _tiff_dtype(tags, bo)
        itemsize = dt.itemsize

        r0, r1 = max(0, rows[0]), min(height, rows[1])
        c0, c1 = (0, width) if cols is None else (
            max(0, cols[0]), min(width, cols[1])
        )
        if not (r0 < r1 and c0 < c1):
            raise ValueError(f"empty window rows={rows} cols={cols}")
        out = np.zeros((r1 - r0, c1 - c0), dt)

        def decode(block: bytes, out_size: int) -> bytes:
            if compression != 5:
                return block
            # blocks may be padded to full rows_per_strip by some
            # writers; cap at the layout size like read_geotiff does
            return _tiffnative.lzw_decode_blocks([block], [out_size])

        if _T_TILE_OFFSETS in tags:
            tw = int(tags[_T_TILE_W][0])
            th = int(tags[_T_TILE_H][0])
            offs = tags[_T_TILE_OFFSETS].astype(np.int64)
            cnts = tags[_T_TILE_COUNTS].astype(np.int64)
            tiles_across = -(-width // tw)
            for ti in range(r0 // th, -(-r1 // th)):
                for tj in range(c0 // tw, -(-c1 // tw)):
                    idx = ti * tiles_across + tj
                    f.seek(int(offs[idx]))
                    buf = decode(f.read(int(cnts[idx])), th * tw * itemsize)
                    block = np.frombuffer(
                        buf[: th * tw * itemsize], dtype=dt
                    ).reshape(th, tw)
                    if predictor == 2:
                        block = np.cumsum(block, axis=1, dtype=block.dtype)
                    br0, bc0 = ti * th, tj * tw
                    rr0, rr1 = max(r0, br0), min(r1, br0 + th, height)
                    cc0, cc1 = max(c0, bc0), min(c1, bc0 + tw, width)
                    out[rr0 - r0 : rr1 - r0, cc0 - c0 : cc1 - c0] = block[
                        rr0 - br0 : rr1 - br0, cc0 - bc0 : cc1 - bc0
                    ]
        else:
            rps = int(tags.get(_T_ROWS_PER_STRIP, np.array([height]))[0])
            offs = tags[_T_STRIP_OFFSETS].astype(np.int64)
            cnts = tags[_T_STRIP_COUNTS].astype(np.int64)
            for si in range(r0 // rps, -(-r1 // rps)):
                s_rows = min(rps, height - si * rps)
                f.seek(int(offs[si]))
                # cap at the FULL strip height: some writers pad the final
                # ragged strip to rows_per_strip (see read_geotiff)
                buf = decode(f.read(int(cnts[si])), rps * width * itemsize)
                strip = np.frombuffer(
                    buf[: s_rows * width * itemsize], dtype=dt
                ).reshape(s_rows, width)
                if predictor == 2:
                    strip = np.cumsum(strip, axis=1, dtype=strip.dtype)
                sr0 = si * rps
                rr0, rr1 = max(r0, sr0), min(r1, sr0 + s_rows)
                out[rr0 - r0 : rr1 - r0] = strip[
                    rr0 - sr0 : rr1 - sr0, c0:c1
                ]

    meta = _tiff_meta(tags)
    if meta["res"] is not None:
        meta["left"] += c0 * meta["res"]
        meta["top"] -= r0 * meta["res"]
    return out, meta


def read_geotiff(path: str, page: int = 0):
    """Read a single-band GeoTIFF. Returns (array (H, W), meta dict) with
    meta keys: left, top, res, nodata (maybe None), crs_epsg (maybe None).

    ``page``: IFD index along the TIFF page chain — 0 is the full-resolution
    raster; pages >= 1 are the overview pyramid levels when the file carries
    them (GeoTiffStripWriter(overviews=N); each page halves the resolution,
    and its meta ``res`` reflects that)."""
    with open(path, "rb") as f:
        raw = f.read()

    byte0 = raw[:2]
    assert byte0 in (b"II", b"MM"), "not a TIFF"
    bo = "<" if byte0 == b"II" else ">"
    magic = struct.unpack(bo + "H", raw[2:4])[0]

    if magic == 42:  # classic
        (ifd_off,) = struct.unpack(bo + "I", raw[4:8])
        entry_size, count_fmt, count_size = 12, "H", 2
        off_fmt = "I"
    elif magic == 43:  # BigTIFF
        ifd_off = struct.unpack(bo + "Q", raw[8:16])[0]
        entry_size, count_fmt, count_size = 20, "Q", 8
        off_fmt = "Q"
    else:
        raise ValueError(f"bad TIFF magic {magic}")

    ptr_size = 4 if magic == 42 else 8
    for _ in range(page):  # walk the IFD chain to the requested page
        (n,) = struct.unpack(bo + count_fmt, raw[ifd_off : ifd_off + count_size])
        nxt = ifd_off + count_size + n * entry_size
        ifd_off = struct.unpack(bo + off_fmt, raw[nxt : nxt + ptr_size])[0]
        if ifd_off == 0:
            raise ValueError(f"TIFF has no page {page}")

    (n_entries,) = struct.unpack(
        bo + count_fmt, raw[ifd_off : ifd_off + count_size]
    )
    tags: Dict[int, np.ndarray] = {}
    base = ifd_off + count_size
    inline = 4 if magic == 42 else 8
    for i in range(n_entries):
        e = raw[base + i * entry_size : base + (i + 1) * entry_size]
        tag, typ = struct.unpack(bo + "HH", e[:4])
        cnt = struct.unpack(bo + off_fmt, e[4 : 4 + (4 if magic == 42 else 8)])[0]
        size = _TYPE_SIZES.get(typ, 1) * cnt
        val_field = e[4 + (4 if magic == 42 else 8) :]
        if size <= inline:
            payload = val_field[:size]
        else:
            off = struct.unpack(bo + off_fmt, val_field)[0]
            payload = raw[off : off + size]
        if typ in _TYPE_FMT:
            tags[tag] = np.frombuffer(
                payload, dtype=np.dtype(bo + _TYPE_FMT[typ]), count=cnt
            )
        elif typ == 2:  # ascii
            tags[tag] = payload
        else:
            tags[tag] = np.frombuffer(payload, dtype=np.uint8)

    width = int(tags[_T_WIDTH][0])
    height = int(tags[_T_HEIGHT][0])
    compression = int(tags.get(_T_COMPRESSION, np.array([1]))[0])
    predictor = int(tags.get(_T_PREDICTOR, np.array([1]))[0])
    assert compression in (1, 5), f"unsupported compression {compression}"
    dt = _tiff_dtype(tags, bo)
    itemsize = dt.itemsize

    def decompress_all(blocks, out_sizes):
        """LZW-decompress every strip/tile: threaded native block decode
        (strips decompress independently).

        Capacities are padded to the LARGEST block size: some writers encode
        the final ragged strip padded to full rows_per_strip, which would
        overflow an exact-size cap and fail the native decode even though the
        extra rows are discarded.
        """
        if compression != 5:
            return list(blocks)
        cap = max(out_sizes)
        flat = _tiffnative.lzw_decode_blocks(blocks, [cap] * len(blocks))
        return [flat[i * cap : i * cap + s] for i, s in enumerate(out_sizes)]

    def to_array(buf: bytes, rows: int, cols: int) -> np.ndarray:
        arr = (
            np.frombuffer(buf[: rows * cols * itemsize], dtype=dt)
            .reshape(rows, cols)
            .copy()
        )
        if predictor == 2:
            arr = np.cumsum(arr, axis=1, dtype=arr.dtype)
        return arr

    out = np.zeros((height, width), dtype=dt)
    if _T_TILE_OFFSETS in tags:
        tw = int(tags[_T_TILE_W][0])
        th = int(tags[_T_TILE_H][0])
        offs = tags[_T_TILE_OFFSETS].astype(np.int64)
        cnts = tags[_T_TILE_COUNTS].astype(np.int64)
        tiles_across = -(-width // tw)
        blocks = [bytes(raw[o : o + c]) for o, c in zip(offs, cnts)]
        decoded = decompress_all(blocks, [th * tw * itemsize] * len(blocks))
        for idx, buf in enumerate(decoded):
            ti, tj = idx // tiles_across, idx % tiles_across
            block = to_array(buf, th, tw)
            r0, c0 = ti * th, tj * tw
            out[r0 : r0 + th, c0 : c0 + tw] = block[
                : min(th, height - r0), : min(tw, width - c0)
            ]
    else:
        rps = int(tags.get(_T_ROWS_PER_STRIP, np.array([height]))[0])
        offs = tags[_T_STRIP_OFFSETS].astype(np.int64)
        cnts = tags[_T_STRIP_COUNTS].astype(np.int64)
        rows_per = [min(rps, height - i * rps) for i in range(len(offs))]
        blocks = [bytes(raw[o : o + c]) for o, c in zip(offs, cnts)]
        decoded = decompress_all(
            blocks, [r * width * itemsize for r in rows_per]
        )
        for idx, buf in enumerate(decoded):
            r0 = idx * rps
            out[r0 : r0 + rows_per[idx]] = to_array(buf, rows_per[idx], width)

    return out, _tiff_meta(tags)


# --------------------------------------------------------------------------
# Writer
# --------------------------------------------------------------------------

def write_geotiff(
    path: str,
    array: np.ndarray,  # (H, W)
    left: float,
    top: float,
    res: float,
    nodata: Optional[float] = None,
    epsg: int = 3031,
    compress: bool = False,
    tiled: bool = False,
    tile_size: int = 512,
    bigtiff: Optional[bool] = None,
    predictor: bool = False,
) -> None:
    """Write a single-band GeoTIFF (classic or BigTIFF, optional LZW).

    ``predictor``: TIFF horizontal differencing (PREDICTOR=2, integer dtypes
    only) before the LZW — spatially smooth rasters like DEMs compress far
    better as per-row deltas (the GDAL convention for elevation products)."""
    array = np.ascontiguousarray(array)
    h, w = array.shape
    dt = array.dtype
    sample_format = {"u": 1, "i": 2, "f": 3}[dt.kind]
    bits = dt.itemsize * 8
    if predictor and (not compress or dt.kind not in "iu"):
        raise ValueError(
            "predictor requires compress=True and an integer dtype "
            "(TIFF PREDICTOR=2 is integer horizontal differencing)"
        )

    # blocks
    blocks = []
    if tiled:
        th = tw = tile_size
        for r0 in range(0, h, th):
            for c0 in range(0, w, tw):
                block = np.zeros((th, tw), dt)
                rr = min(th, h - r0)
                cc = min(tw, w - c0)
                block[:rr, :cc] = array[r0 : r0 + rr, c0 : c0 + cc]
                blocks.append(_hdiff(block).tobytes() if predictor
                              else block.tobytes())
    else:
        th = max(1, (1 << 20) // max(1, w * dt.itemsize))  # ~1MB strips
        for r0 in range(0, h, th):
            strip = array[r0 : min(r0 + th, h)]
            blocks.append(_hdiff(strip).tobytes() if predictor
                          else strip.tobytes())

    if compress:
        blocks = _tiffnative.lzw_encode_blocks(blocks)

    total = sum(len(b) for b in blocks)
    if bigtiff is None:
        bigtiff = total + 65536 > 0xFFFF0000

    geo_keys = np.array(
        [
            1, 1, 0, 3,  # version, revision, minor, number of keys
            1024, 0, 1, 1,  # GTModelTypeGeoKey = projected
            1025, 0, 1, 1,  # GTRasterTypeGeoKey = PixelIsArea
            3072, 0, 1, epsg,  # ProjectedCSTypeGeoKey
        ],
        np.uint16,
    )
    pixel_scale = np.array([res, res, 0.0], np.float64)
    tiepoint = np.array([0, 0, 0, left, top, 0.0], np.float64)

    entries = [
        (_T_WIDTH, 3, [w]),
        (_T_HEIGHT, 3, [h]),
        (_T_BITS, 3, [bits]),
        (_T_COMPRESSION, 3, [5 if compress else 1]),
        (_T_PHOTOMETRIC, 3, [1]),
        (_T_SAMPLES, 3, [1]),
        (_T_SAMPLE_FORMAT, 3, [sample_format]),
        (_T_PIXEL_SCALE, 12, pixel_scale.tolist()),
        (_T_TIEPOINT, 12, tiepoint.tolist()),
        (_T_GEO_KEYS, 3, geo_keys.tolist()),
    ]
    if predictor:
        entries.append((_T_PREDICTOR, 3, [2]))
    if tiled:
        entries += [
            (_T_TILE_W, 3, [tw]),
            (_T_TILE_H, 3, [th]),
            (_T_TILE_OFFSETS, None, blocks),  # filled below
            (_T_TILE_COUNTS, 4, [len(b) for b in blocks]),
        ]
    else:
        entries += [
            (_T_ROWS_PER_STRIP, 3, [th]),
            (_T_STRIP_OFFSETS, None, blocks),
            (_T_STRIP_COUNTS, 4, [len(b) for b in blocks]),
        ]
    if nodata is not None:
        nd = (
            str(int(nodata)) if float(nodata).is_integer() else repr(float(nodata))
        ).encode() + b"\x00"
        entries.append((_T_GDAL_NODATA, 2, nd))
    entries.sort(key=lambda e: e[0])

    bo = "<"
    if not bigtiff:
        header_size = 8
        entry_size, count_size, inline, off_fmt, count_fmt = 12, 2, 4, "I", "H"
        off_type = 4
    else:
        header_size = 16
        entry_size, count_size, inline, off_fmt, count_fmt = 20, 8, 8, "Q", "Q"
        off_type = 16

    ifd_off = header_size
    ifd_size = count_size + len(entries) * entry_size + (4 if not bigtiff else 8)
    aux_off = ifd_off + ifd_size  # out-of-line tag payloads start here

    # lay out out-of-line payloads, then block data
    payloads = []

    def payload_bytes(typ, values):
        if typ == 2:
            return bytes(values)
        fmt = _TYPE_FMT[typ]
        return struct.pack(bo + fmt * len(values), *values)

    # first pass: compute where block data will live
    fixed_payload_size = 0
    for tag, typ, values in entries:
        if typ is None:
            continue
        size = len(values) if typ == 2 else _TYPE_SIZES[typ] * len(values)
        if size > inline:
            fixed_payload_size += (size + 1) & ~1
    # offsets tag payload size (depends on count)
    n_blocks = len(blocks)
    offsets_typ = 16 if bigtiff else 4
    offsets_payload = n_blocks * _TYPE_SIZES[offsets_typ]
    if offsets_payload > inline:
        fixed_payload_size += (offsets_payload + 1) & ~1

    data_off = aux_off + fixed_payload_size
    block_offsets = []
    pos = data_off
    for b in blocks:
        block_offsets.append(pos)
        pos += (len(b) + 1) & ~1

    # second pass: serialise entries
    out_entries = b""
    aux_cursor = aux_off
    aux_chunks = []
    for tag, typ, values in entries:
        if typ is None:  # offsets tag
            typ = offsets_typ
            values = block_offsets
        if typ == 2:
            payload = payload_bytes(typ, values)
            cnt = len(payload)
        else:
            payload = payload_bytes(typ, values)
            cnt = len(values)
        if len(payload) <= inline:
            val_field = payload + b"\x00" * (inline - len(payload))
        else:
            val_field = struct.pack(bo + off_fmt, aux_cursor)
            padded = payload + (b"\x00" if len(payload) & 1 else b"")
            aux_chunks.append(padded)
            aux_cursor += len(padded)
        out_entries += struct.pack(bo + "HH", tag, typ)
        out_entries += struct.pack(bo + off_fmt, cnt)
        out_entries += val_field

    with open(path, "wb") as f:
        if not bigtiff:
            f.write(b"II" + struct.pack("<H", 42) + struct.pack("<I", ifd_off))
        else:
            f.write(
                b"II"
                + struct.pack("<HHH", 43, 8, 0)
                + struct.pack("<Q", ifd_off)
            )
        f.write(struct.pack(bo + count_fmt, len(entries)))
        f.write(out_entries)
        f.write(struct.pack(bo + off_fmt, 0))  # next IFD
        for chunk in aux_chunks:
            f.write(chunk)
        assert f.tell() == data_off, (f.tell(), data_off)
        for b in blocks:
            f.write(b)
            if len(b) & 1:
                f.write(b"\x00")


def _hdiff(a: np.ndarray) -> np.ndarray:
    """TIFF PREDICTOR=2 horizontal differencing: each pixel becomes the
    delta to its left neighbour (modular in the integer dtype — the reader's
    same-dtype cumsum inverts it exactly)."""
    d = a.copy()
    d[:, 1:] = a[:, 1:] - a[:, :-1]
    return d


# --------------------------------------------------------------------------
# Streaming strip writer — bands in, IFD at close
# --------------------------------------------------------------------------

def _block2x2(a: np.ndarray) -> np.ndarray:
    """2x2 block sums of an even-row-count (N, W) chunk -> (N/2, ceil(W/2)),
    accumulated exactly in float64; an odd final column covers a 2x1 block.

    Row-at-a-time on purpose: each row pair stays L2-resident, where
    whole-array reshape reductions and strided-view adds are DRAM-bound —
    measured 4-7x slower on this host at continent width (22000 cols). The
    astype (not np.add with a float64 out=) also keeps bool count rows
    correct: np.add on bools saturates (True+True == True)."""
    n, wd = a.shape
    w2 = wd // 2
    odd = wd & 1
    out = np.empty((n // 2, w2 + odd), np.float64)
    for i in range(n // 2):
        rp = a[2 * i].astype(np.float64)
        rp += a[2 * i + 1]
        out[i, :w2] = rp[: 2 * w2 : 2] + rp[1 : 2 * w2 : 2]
        if odd:
            out[i, w2] = rp[-1]
    return out


def _colpair_row(row: np.ndarray) -> np.ndarray:
    """Adjacent-column sums of one row (the odd-height tail: 1x2 blocks)."""
    wd = row.shape[0]
    w2 = wd // 2
    out = row[: 2 * w2].reshape(w2, 2).sum(axis=1, dtype=np.float64)
    if wd & 1:
        out = np.append(out, np.float64(row[-1]))
    return out

class GeoTiffStripWriter:
    """Incremental single-band GeoTIFF writer: strips append as they arrive
    (each ``write_strip`` call = one TIFF strip), the IFD lands at EOF on
    ``close()`` and the header pointer is patched. This is what lets
    whole-continent inference overlap device compute with LZW encoding and
    disk I/O (inference.continent.predict_continent_to_geotiff) instead of
    buffering an 18000x22000 canvas and writing it afterwards.

    The reference buffers the full canvas and writes once at the end
    (deepbedmap.py:744-756).
    """

    def __init__(
        self,
        path: str,
        height: int,
        width: int,
        left: float,
        top: float,
        res: float,
        dtype=np.int16,
        nodata: Optional[float] = None,
        epsg: int = 3031,
        compress: bool = True,
        bigtiff: Optional[bool] = None,
        rows_per_strip: Optional[int] = None,
        overviews: int = 0,
        predictor: bool = False,
    ):
        """``rows_per_strip``: when set, each ``write_strip`` call is split
        into TIFF strips of this many rows and the sub-strips LZW-encode in
        PARALLEL (native thread pool) — without it a whole 1000-row continent
        band is one single-threaded encode, which becomes the product
        bottleneck once a mesh drops compute below encode time. Every
        ``write_strip`` row count except the final one must be a multiple of
        it (TIFF strips must share RowsPerStrip except the last).

        ``overviews``: number of 2x reduced-resolution pyramid levels to
        build INCREMENTALLY from the strips and append as chained TIFF pages
        (NewSubfileType=1, the GDAL-internal-overview convention — what
        ``gdaladdo -r average`` produces). Each level-L pixel is the exact
        nodata-aware mean of its valid 2^L x 2^L source block (a sum/count
        cascade, so cascading introduces no weighting error); all-invalid
        blocks become nodata. Memory stays bounded: one pending row pair per
        level plus at most one overview strip. Read levels back with
        ``read_geotiff(path, page=L)``.

        ``predictor``: TIFF PREDICTOR=2 horizontal differencing before the
        LZW (integer dtypes; applies to overview pages too) — smooth DEM
        rasters compress far better as per-row deltas (the GDAL convention
        for elevation products)."""
        if predictor and (not compress or np.dtype(dtype).kind not in "iu"):
            raise ValueError(
                "predictor requires compress=True and an integer dtype "
                "(TIFF PREDICTOR=2 is integer horizontal differencing)"
            )
        self.predictor = predictor
        self.path = path
        self.height, self.width = height, width
        self.left, self.top, self.res = left, top, res
        self.dtype = np.dtype(dtype)
        self.nodata = nodata
        self.epsg = epsg
        self.compress = compress
        self.rows_per_strip = rows_per_strip
        self.overviews = overviews
        self._ov_rps = max(1, rows_per_strip or 256)
        self._ov_levels: list = []
        h, w = height, width
        for _ in range(overviews):
            h, w = -(-h // 2), -(-w // 2)
            self._ov_levels.append(
                {
                    "h": h, "w": w,
                    "carry": None,   # (sum, count) row awaiting its pair
                    "s_pend": [], "c_pend": [], "n_pend": 0,  # rows awaiting flush
                    "offsets": [], "counts": [], "strip_rows": [],
                }
            )
        if bigtiff is None:  # conservative: decide from the uncompressed size
            bigtiff = height * width * self.dtype.itemsize + 65536 > 0xFFFF0000
        self.bigtiff = bigtiff
        self._offsets: list = []
        self._counts: list = []
        self._strip_rows: list = []
        self._rows_written = 0
        self._f = open(path, "wb")
        if not bigtiff:
            self._f.write(b"II" + struct.pack("<H", 42) + struct.pack("<I", 0))
        else:
            self._f.write(
                b"II" + struct.pack("<HHH", 43, 8, 0) + struct.pack("<Q", 0)
            )

    def write_strip(self, rows: np.ndarray) -> None:
        """Append one strip (or, with ``rows_per_strip``, a run of uniform
        strips encoded in parallel) of full-width rows; converted to
        ``dtype`` with NaN -> nodata when set."""
        assert rows.ndim == 2 and rows.shape[1] == self.width, rows.shape
        assert self._rows_written + rows.shape[0] <= self.height
        if self._ov_levels:
            # feed the pyramid from the PRE-conversion values: NaN and
            # nodata-valued pixels carry zero weight in the block means
            self._feed_overview0(rows)
        if self.nodata is not None and rows.dtype.kind == "f":
            rows = np.where(np.isfinite(rows), rows, self.nodata)
        rows = np.ascontiguousarray(rows.astype(self.dtype))

        rps = self.rows_per_strip or rows.shape[0]
        chunks = [rows[i : i + rps] for i in range(0, rows.shape[0], rps)]
        blocks = [
            (_hdiff(c) if self.predictor else c).tobytes() for c in chunks
        ]
        if self.compress:
            if len(blocks) > 1:
                blocks = _tiffnative.lzw_encode_blocks(blocks)  # parallel threads
            else:
                blocks = [_tiffnative.lzw_encode(blocks[0])]
        for chunk, block in zip(chunks, blocks):
            pos = self._f.tell()
            self._offsets.append(pos)
            self._counts.append(len(block))
            self._strip_rows.append(chunk.shape[0])
            self._f.write(block)
            if len(block) & 1:
                self._f.write(b"\x00")
            self._rows_written += chunk.shape[0]

    # ---- overview pyramid (sum/count cascade) ----

    def _mask_row(self, r: np.ndarray):
        """One raw full-res row -> (sum, count) float64 rows: NaN and
        nodata-valued pixels carry zero sum and zero weight."""
        rf = r.astype(np.float64)
        m = np.isfinite(rf)
        if self.nodata is not None:
            m &= rf != self.nodata
        return np.where(m, rf, 0.0), m.astype(np.float64)

    def _feed_overview0(self, rows: np.ndarray) -> None:
        """Level-0 feed straight from raw strip rows. Masking, row pairing
        and column pairing all happen one row pair at a time so every
        intermediate stays L2-resident — full-array np.isfinite/np.where
        passes at continent width are DRAM-bound on weak-memory hosts
        (measured ~5x the cost of this loop)."""
        lv = self._ov_levels[0]
        start = 0
        head = None
        if lv["carry"] is not None and rows.shape[0] > 0:
            s0, c0 = lv["carry"]
            lv["carry"] = None
            s1, c1 = self._mask_row(rows[0])
            start = 1
            head = (_colpair_row(s0 + s1), _colpair_row(c0 + c1))
        n_rest = rows.shape[0] - start
        pairs = n_rest // 2
        if n_rest & 1:
            lv["carry"] = self._mask_row(rows[-1])
        wd = rows.shape[1]
        w2 = wd // 2
        odd = wd & 1
        n_out = pairs + (1 if head is not None else 0)
        if not n_out:
            return
        s2 = np.empty((n_out, w2 + odd), np.float64)
        c2 = np.empty_like(s2)
        o = 0
        if head is not None:
            s2[0], c2[0] = head
            o = 1
        for i in range(pairs):
            sa, ca = self._mask_row(rows[start + 2 * i])
            sb, cb = self._mask_row(rows[start + 2 * i + 1])
            sa += sb
            ca += cb
            s2[o + i, :w2] = sa[: 2 * w2 : 2] + sa[1 : 2 * w2 : 2]
            c2[o + i, :w2] = ca[: 2 * w2 : 2] + ca[1 : 2 * w2 : 2]
            if odd:
                s2[o + i, w2] = sa[-1]
                c2[o + i, w2] = ca[-1]
        self._append_overview_rows(0, s2, c2)

    def _feed_overview(self, level: int, s: np.ndarray, c: np.ndarray) -> None:
        """Accept a CHUNK of (sum, count) rows — shape (N, parent width) —
        at level ``level``'s input resolution (full-res rows for level 0,
        level-(L-1) output rows otherwise); vectorized over the chunk."""
        lv = self._ov_levels[level]
        if lv["carry"] is not None:
            s = np.concatenate([lv["carry"][0][None].astype(np.float64), s])
            c = np.concatenate([lv["carry"][1][None].astype(np.float64), c])
            lv["carry"] = None
        pairs = s.shape[0] // 2
        if s.shape[0] & 1:
            lv["carry"] = (
                s[-1].astype(np.float64), c[-1].astype(np.float64)
            )
        if not pairs:
            return
        s2 = _block2x2(np.ascontiguousarray(s[: 2 * pairs]))
        c2 = _block2x2(np.ascontiguousarray(c[: 2 * pairs]))
        self._append_overview_rows(level, s2, c2)

    def _append_overview_rows(
        self, level: int, s2: np.ndarray, c2: np.ndarray
    ) -> None:
        """Queue finished level rows, cascade them downward, flush strips."""
        lv = self._ov_levels[level]
        lv["s_pend"].append(s2)
        lv["c_pend"].append(c2)
        lv["n_pend"] += s2.shape[0]
        if level + 1 < len(self._ov_levels):
            self._feed_overview(level + 1, s2, c2)
        if lv["n_pend"] >= self._ov_rps:
            self._flush_overview(level, final=False)

    def _flush_overview(self, level: int, final: bool) -> None:
        lv = self._ov_levels[level]
        s_all = np.concatenate(lv["s_pend"]) if lv["s_pend"] else None
        c_all = np.concatenate(lv["c_pend"]) if lv["c_pend"] else None
        pos = 0
        while (
            s_all is not None
            and (s_all.shape[0] - pos >= self._ov_rps
                 or (final and pos < s_all.shape[0]))
        ):
            s = s_all[pos : pos + self._ov_rps]
            c = c_all[pos : pos + self._ov_rps]
            pos += s.shape[0]
            with np.errstate(invalid="ignore", divide="ignore"):
                vals = s / c
            fill = self.nodata if self.nodata is not None else 0.0
            vals = np.where(c > 0, vals, fill)
            if self.dtype.kind in "iu":
                vals = np.rint(vals)
            arr = np.ascontiguousarray(vals.astype(self.dtype))
            block = (_hdiff(arr) if self.predictor else arr).tobytes()
            if self.compress:
                block = _tiffnative.lzw_encode(block)
            lv["offsets"].append(self._f.tell())
            lv["counts"].append(len(block))
            lv["strip_rows"].append(arr.shape[0])
            self._f.write(block)
            if len(block) & 1:
                self._f.write(b"\x00")
        if s_all is None or pos == 0:
            return
        if pos < s_all.shape[0]:  # keep the sub-strip remainder pending
            lv["s_pend"] = [s_all[pos:]]
            lv["c_pend"] = [c_all[pos:]]
            lv["n_pend"] = s_all.shape[0] - pos
        else:
            lv["s_pend"], lv["c_pend"], lv["n_pend"] = [], [], 0

    def _finalize_overviews(self) -> None:
        """Flush odd-row carries and remaining partial strips, top level
        first so every flushed row still cascades to the deeper levels."""
        for level, lv in enumerate(self._ov_levels):
            if lv["carry"] is not None:  # odd height: a 1x2 tail block row
                s, c = lv["carry"]
                lv["carry"] = None
                self._append_overview_rows(
                    level, _colpair_row(s)[None], _colpair_row(c)[None]
                )
            self._flush_overview(level, final=True)
            assert sum(lv["strip_rows"]) == lv["h"], (
                level, sum(lv["strip_rows"]), lv["h"],
            )

    def close(self) -> None:
        assert self._rows_written == self.height, (
            self._rows_written, self.height,
        )
        self._finalize_overviews()
        # all strips must share RowsPerStrip except the last (TIFF contract)
        if len(self._strip_rows) > 1:
            assert len(set(self._strip_rows[:-1])) == 1, self._strip_rows

        # one IFD per page: the full raster, then each overview level
        # (NewSubfileType=1, res doubled per level), chained through the
        # next-IFD pointers
        pages = [
            self._ifd_entries(
                self.width, self.height, self._strip_rows[0],
                self._offsets, self._counts, self.res, subfile=None,
            )
        ]
        for level, lv in enumerate(self._ov_levels):
            pages.append(
                self._ifd_entries(
                    lv["w"], lv["h"], lv["strip_rows"][0],
                    lv["offsets"], lv["counts"],
                    self.res * (2 ** (level + 1)), subfile=1,
                )
            )

        prev_next_pos = None
        first_ifd = None
        for entries in pages:
            ifd_off, next_pos = self._write_ifd(entries)
            if prev_next_pos is None:
                first_ifd = ifd_off
            else:  # patch the previous page's next-IFD pointer
                end = self._f.tell()
                self._f.seek(prev_next_pos)
                self._f.write(
                    struct.pack("<" + ("I" if not self.bigtiff else "Q"), ifd_off)
                )
                self._f.seek(end)
            prev_next_pos = next_pos
        # patch the header's IFD pointer
        self._f.seek(4 if not self.bigtiff else 8)
        self._f.write(
            struct.pack("<" + ("I" if not self.bigtiff else "Q"), first_ifd)
        )
        self._f.close()

    def _ifd_entries(
        self, width, height, rps, offsets, counts, res, subfile
    ) -> list:
        dt = self.dtype
        sample_format = {"u": 1, "i": 2, "f": 3}[dt.kind]
        geo_keys = np.array(
            [
                1, 1, 0, 3,
                1024, 0, 1, 1,
                1025, 0, 1, 1,
                3072, 0, 1, self.epsg,
            ],
            np.uint16,
        )
        entries = [
            (_T_WIDTH, 3, [width]),
            (_T_HEIGHT, 3, [height]),
            (_T_BITS, 3, [dt.itemsize * 8]),
            (_T_COMPRESSION, 3, [5 if self.compress else 1]),
            (_T_PHOTOMETRIC, 3, [1]),
            (_T_SAMPLES, 3, [1]),
            (_T_ROWS_PER_STRIP, 3, [rps]),
            (_T_STRIP_OFFSETS, 16 if self.bigtiff else 4, offsets),
            (_T_STRIP_COUNTS, 4, counts),
            (_T_SAMPLE_FORMAT, 3, [sample_format]),
            (_T_PIXEL_SCALE, 12, [res, res, 0.0]),
            (_T_TIEPOINT, 12, [0, 0, 0, self.left, self.top, 0.0]),
            (_T_GEO_KEYS, 3, geo_keys.tolist()),
        ]
        if subfile is not None:
            entries.append((_T_SUBFILETYPE, 4, [subfile]))
        if self.predictor:
            entries.append((_T_PREDICTOR, 3, [2]))
        if self.nodata is not None:
            nd = (
                str(int(self.nodata))
                if float(self.nodata).is_integer()
                else repr(float(self.nodata))
            ).encode() + b"\x00"
            entries.append((_T_GDAL_NODATA, 2, nd))
        entries.sort(key=lambda e: e[0])
        return entries

    def _write_ifd(self, entries) -> tuple:
        """Serialize one IFD (with a zeroed next-IFD pointer) at EOF.
        Returns (ifd_offset, file position of the next-IFD pointer)."""
        bo = "<"
        if not self.bigtiff:
            entry_size, count_size, inline, off_fmt, count_fmt = 12, 2, 4, "I", "H"
        else:
            entry_size, count_size, inline, off_fmt, count_fmt = 20, 8, 8, "Q", "Q"

        if self._f.tell() & 1:
            self._f.write(b"\x00")
        ifd_off = self._f.tell()
        next_ptr_size = 4 if not self.bigtiff else 8
        ifd_size = count_size + len(entries) * entry_size + next_ptr_size
        aux_cursor = ifd_off + ifd_size

        def payload_bytes(typ, values):
            if typ == 2:
                return bytes(values)
            return struct.pack(bo + _TYPE_FMT[typ] * len(values), *values)

        out_entries = b""
        aux_chunks = []
        for tag, typ, values in entries:
            payload = payload_bytes(typ, values)
            cnt = len(payload) if typ == 2 else len(values)
            if len(payload) <= inline:
                val_field = payload + b"\x00" * (inline - len(payload))
            else:
                val_field = struct.pack(bo + off_fmt, aux_cursor)
                padded = payload + (b"\x00" if len(payload) & 1 else b"")
                aux_chunks.append(padded)
                aux_cursor += len(padded)
            out_entries += struct.pack(bo + "HH", tag, typ)
            out_entries += struct.pack(bo + off_fmt, cnt)
            out_entries += val_field

        self._f.write(struct.pack(bo + count_fmt, len(entries)))
        self._f.write(out_entries)
        next_pos = self._f.tell()
        self._f.write(struct.pack(bo + off_fmt, 0))
        for chunk in aux_chunks:
            self._f.write(chunk)
        return ifd_off, next_pos

    def abort(self, unlink: bool = True) -> None:
        """Tear down a failed write: close the handle and (by default) remove
        the partial file. A partial streamed TIFF is never readable — its
        header's first-IFD pointer is only patched in ``close()`` — but
        leaving a .tif on disk after a crash is a corrupt-but-plausible
        product waiting to be shipped, so failure paths must call this
        instead of reaching into the handle. Idempotent; safe after
        ``close()`` (then it never unlinks a finalized product)."""
        import os

        finalized = self._f.closed
        if not finalized:
            self._f.close()
            if unlink:
                try:
                    os.unlink(self.path)
                except FileNotFoundError:
                    pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()
