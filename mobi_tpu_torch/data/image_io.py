"""Image files in numpy: a baseline JPEG decoder, and PNG both ways.

The port depends on neither PIL nor cv2, and nuScenes' camera frames are
baseline 4:2:0 JPEGs, so this module is how the port reads them.
`read_image(path)` returns uint8 [H, W, 3] RGB, as PIL's
`Image.open(path).convert("RGB")` does, and picks the decoder by the file's
magic bytes. `read_gray(path)` returns uint8 [H, W] as cv2's
`imread(path, IMREAD_GRAYSCALE)` does: a JPEG's luma plane (what libjpeg
outputs for JCS_GRAYSCALE, not a conversion of the RGB), a colour PNG
through libpng's rgb_to_gray with the weights cv2 sets.

JPEG: baseline and extended sequential Huffman (SOF0/SOF1), 8-bit, 1 or 3
components, any sampling factors, restart intervals. The entropy decoder is a
Python loop over a table of every 16-bit window of the bit stream; the
dequantisation, libjpeg's integer inverse DCT (jidctint.c, ISLOW), its
"fancy" triangular chroma upsampling (jdsample.c: h2v1, h1v2, h2v2) and its
integer YCbCr -> RGB (jdcolor.c) run on all blocks at once in numpy, so the
output follows libjpeg-turbo's arithmetic. Progressive and arithmetic-coded
files raise NotImplementedError.

PNG: 8-bit gray, RGB and RGBA, all five row filters, not interlaced.
`write_png` writes Sub-filtered rows.
"""
from __future__ import annotations

import struct
import zlib
from array import array
from typing import Dict, List

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

# natural-order index of each zigzag position
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)


def read_image(path: str) -> np.ndarray:
    """A JPEG or PNG file -> uint8 [H, W, 3] RGB (gray replicated, alpha
    dropped)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] == b"\xff\xd8\xff":
        img = decode_jpeg(data)
    elif data[:8] == _PNG_MAGIC:
        img = decode_png(data)
        if img.ndim == 3 and img.shape[2] == 4:
            img = img[..., :3]
    else:
        raise ValueError(f"{path}: neither a JPEG nor a PNG file")
    if img.ndim == 2 or img.shape[2] == 1:
        img = np.repeat(img.reshape(img.shape[0], img.shape[1], 1), 3, axis=2)
    return np.ascontiguousarray(img)


def read_gray(path: str) -> np.ndarray:
    """A JPEG or PNG file -> uint8 [H, W], as cv2.imread(path,
    IMREAD_GRAYSCALE) decodes it (cv2 5.0): a JPEG's Y plane; a PNG's gray
    plane, or its RGB (alpha dropped) as (9797 R + 19234 G + 3737 B) >> 15,
    libpng's rgb_to_gray at cv2's 0.299 / 0.587 without rounding."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data, luma_only=True)
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: neither a JPEG nor a PNG file")
    img = decode_png(data)
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.int64)
    return ((rgb[..., 0] * 9797 + rgb[..., 1] * 19234 + rgb[..., 2] * 3737) >> 15).astype(np.uint8)


def image_size(path: str) -> tuple:
    """(width, height) of a JPEG or PNG file from its header alone, as
    PIL's `Image.open(path).size` gives it (PNG: IHDR; JPEG: the first SOFn
    frame header)."""
    with open(path, "rb") as f:
        data = f.read(8)
        if data == _PNG_MAGIC:
            width, height = struct.unpack(">II", f.read(16)[8:16])
            return width, height
        if data[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: neither a JPEG nor a PNG file")
        f.seek(2)
        while True:
            byte = f.read(1)
            if not byte:
                raise ValueError(f"{path}: JPEG without a frame header")
            if byte != b"\xff":
                continue
            marker = f.read(1)[0]
            while marker == 0xFF:
                marker = f.read(1)[0]
            if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
                continue
            (length,) = struct.unpack(">H", f.read(2))
            if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                height, width = struct.unpack(">xHH", f.read(5))
                return width, height
            f.seek(length - 2, 1)


# -------------------------------------------------------------------- JPEG


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.coef = None  # int64 [rows of blocks, cols of blocks, 64], zigzag order


def _huffman_lut(counts: bytes, symbols: bytes) -> List[int]:
    """A 65536-entry table: for each 16-bit window, symbol | (code length
    << 8), or 0 where no code starts the window."""
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            entry = symbols[k] | (length << 8)
            lut[lo:lo + (1 << (16 - length))] = [entry] * (1 << (16 - length))
            code += 1
            k += 1
        code <<= 1
    return lut


def _windows(segment: bytes) -> array:
    """Every 16-bit window of the bit stream (byte stuffing removed), by its
    first bit, with zero bits past the end."""
    b = np.frombuffer(segment.replace(b"\xff\x00", b"\xff") + b"\x00\x00\x00", np.uint8).astype(np.uint32)
    v24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    win = np.stack([(v24 >> (8 - r)) & 0xFFFF for r in range(8)], axis=1).reshape(-1)
    return array("H", win.astype(np.uint16).tobytes())


def _decode_segment(segment: bytes, plan, n_mcus: int, dc_pred: List[int], out_idx, out_val) -> None:
    """Entropy-decode n_mcus MCUs of one restart segment. `plan` lists, per
    block of an MCU, (component slot, DC table, AC table, block offset);
    each MCU's blocks start at the offsets `plan` yields with the MCU index."""
    win = _windows(segment)
    p = 0
    for m in range(n_mcus):
        for slot, dc_lut, ac_lut, base in plan(m):
            v = dc_lut[win[p]]
            if not v:
                raise ValueError("JPEG: bad Huffman code")
            p += v >> 8
            s = v & 0xFF
            diff = 0
            if s:
                diff = win[p] >> (16 - s)
                p += s
                if diff < 1 << (s - 1):
                    diff -= (1 << s) - 1
            dc_pred[slot] += diff
            idx, val = out_idx[slot], out_val[slot]
            idx.append(base)
            val.append(dc_pred[slot])
            k = 1
            while k < 64:
                v = ac_lut[win[p]]
                if not v:
                    raise ValueError("JPEG: bad Huffman code")
                p += v >> 8
                r, s = (v >> 4) & 0xF, v & 0xF
                if s:
                    k += r
                    a = win[p] >> (16 - s)
                    p += s
                    if a < 1 << (s - 1):
                        a -= (1 << s) - 1
                    idx.append(base + k)
                    val.append(a)
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break


def _idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg's jpeg_idct_islow on [N, 64] natural-order coefficients with
    the natural-order quantisation table q -> uint8 [N, 8, 8]."""
    c13, p1 = 13, 2

    def fix(x):
        return int(x * (1 << c13) + 0.5)

    def stage(g, shift, rows):
        # g[i] is the i-th input along the transformed axis
        z2, z3 = g[2], g[6]
        z1 = (z2 + z3) * fix(0.541196100)
        tmp2 = z1 + z3 * -fix(1.847759065)
        tmp3 = z1 + z2 * fix(0.765366865)
        tmp0 = (g[0] + g[4]) << c13
        tmp1 = (g[0] - g[4]) << c13
        t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        tmp0, tmp1, tmp2, tmp3 = g[7], g[5], g[3], g[1]
        z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
        z5 = (z3 + z4) * fix(1.175875602)
        tmp0 = tmp0 * fix(0.298631336)
        tmp1 = tmp1 * fix(2.053119869)
        tmp2 = tmp2 * fix(3.072711026)
        tmp3 = tmp3 * fix(1.501321110)
        z1 = z1 * -fix(0.899976223)
        z2 = z2 * -fix(2.562915447)
        z3 = z3 * -fix(1.961570560) + z5
        z4 = z4 * -fix(0.390180644) + z5
        tmp0 += z1 + z3
        tmp1 += z2 + z4
        tmp2 += z2 + z3
        tmp3 += z1 + z4
        half = 1 << (shift - 1)
        outs = [t10 + tmp3, t11 + tmp2, t12 + tmp1, t13 + tmp0,
                t13 - tmp0, t12 - tmp1, t11 - tmp2, t10 - tmp3]
        return np.stack([(o + half) >> shift for o in outs], axis=rows)

    x = (coef.astype(np.int64) * q.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (along the row index), pass 2: rows
    ws = stage([x[:, i, :] for i in range(8)], c13 - p1, rows=1)
    out = stage([ws[:, :, i] for i in range(8)], c13 + p1 + 3, rows=2)
    # the post-IDCT range limit: a 10-bit wrap, then clamp(v + 128)
    out = ((out + 512) & 1023) - 512
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _upsample(x: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of one component plane by (hs, vs): fancy
    (triangle filter) for 2x1, 1x2 and 2x2, replication otherwise."""
    x = x.astype(np.int32)
    if hs == 1 and vs == 1:
        return x
    w = x.shape[1]
    if (hs, vs) == (2, 1) and w > 2:
        out = np.empty((x.shape[0], 2 * w), np.int32)
        c3 = x * 3
        out[:, 0::2] = np.concatenate([x[:, :1], (c3[:, 1:] + x[:, :-1] + 1) >> 2], axis=1)
        out[:, 1::2] = np.concatenate([(c3[:, :-1] + x[:, 1:] + 2) >> 2, x[:, -1:]], axis=1)
        return out
    if (hs, vs) == (1, 2):
        above = np.concatenate([x[:1], x[:-1]], axis=0)
        below = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * x.shape[0], w), np.int32)
        out[0::2] = (x * 3 + above + 1) >> 2
        out[1::2] = (x * 3 + below + 2) >> 2
        return out
    if (hs, vs) == (2, 2) and w > 2:
        above = np.concatenate([x[:1], x[:-1]], axis=0)
        below = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * x.shape[0], 2 * w), np.int32)
        for r, near in ((0, above), (1, below)):
            s = x * 3 + near  # column sums of the two nearest rows
            left = np.concatenate([s[:, :1], (s[:, 1:] * 3 + s[:, :-1] + 8) >> 4], axis=1)
            left[:, 0] = (s[:, 0] * 4 + 8) >> 4
            right = np.concatenate([(s[:, :-1] * 3 + s[:, 1:] + 7) >> 4, (s[:, -1:] * 4 + 7) >> 4], axis=1)
            out[r::2, 0::2] = left
            out[r::2, 1::2] = right
        return out
    return np.repeat(np.repeat(x, vs, axis=0), hs, axis=1)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's ycc_rgb_convert: 16-bit fixed-point tables."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)

    half = 1 << 15
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    y = y.astype(np.int64)
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb + half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, luma_only: bool = False) -> np.ndarray:
    """A baseline or extended sequential Huffman JPEG -> uint8 [H, W, 3]
    (three components) or [H, W] (one, or the first of three with
    `luma_only`: libjpeg's JCS_GRAYSCALE output of a YCbCr file)."""
    qt: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, List[int]] = {}
    ac_tabs: Dict[int, List[int]] = {}
    comps: List[_Component] = []
    height = width = 0
    restart = 0
    pos = 2
    while True:
        while data[pos] != 0xFF or data[pos + 1] == 0xFF:
            pos += 1
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        pos += length
        if marker == 0xDB:  # DQT
            k = 0
            while k < len(seg):
                pq, tq = seg[k] >> 4, seg[k] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(seg[k + 1:k + 1 + n], ">u2" if pq else np.uint8).astype(np.int64)
                table = np.empty(64, np.int64)
                table[_ZIGZAG] = vals
                qt[tq] = table
                k += 1 + n
        elif marker == 0xC4:  # DHT
            k = 0
            while k < len(seg):
                tc, th = seg[k] >> 4, seg[k] & 15
                counts = seg[k + 1:k + 17]
                n = sum(counts)
                lut = _huffman_lut(counts, seg[k + 17:k + 17 + n])
                (ac_tabs if tc else dc_tabs)[th] = lut
                k += 17 + n
        elif marker in (0xC0, 0xC1):  # SOF0 / SOF1
            precision, height, width, nc = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise NotImplementedError(f"JPEG: {precision}-bit samples")
            comps = [_Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                     for i in range(nc)]
            if nc not in (1, 3):
                raise NotImplementedError(f"JPEG: {nc} components")
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise NotImplementedError(f"JPEG: SOF{marker - 0xC0} (progressive, lossless or "
                                      "arithmetic-coded) files are not supported")
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12 and seg[11] == 0:
            raise NotImplementedError("JPEG: RGB-coded (Adobe transform 0) files are not supported")
        elif marker == 0xDA:  # SOS
            pos = _decode_scan(data, pos, seg, comps, dc_tabs, ac_tabs, width, height, restart)
    if not comps:
        raise ValueError("JPEG: no frame header")
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    planes = []
    for c in comps[:1] if luma_only else comps:
        if c.coef is None:
            raise ValueError("JPEG: a component has no scan")
        rows, cols = c.coef.shape[:2]
        nat = np.zeros((rows * cols, 64), np.int64)
        nat[:, _ZIGZAG] = c.coef.reshape(-1, 64)
        blocks = _idct_islow(nat, qt[c.tq])
        plane = blocks.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
        cw = -(-width * c.h // hmax)
        ch = -(-height * c.v // vmax)
        up = _upsample(plane[:ch, :cw], hmax // c.h, vmax // c.v)
        planes.append(up[:height, :width])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    return _ycc_to_rgb(*planes)


def _decode_scan(data, pos, seg, comps, dc_tabs, ac_tabs, width, height, restart) -> int:
    """Decode one scan starting at `pos`; returns the position after its
    entropy-coded data."""
    ns = seg[0]
    scan = []
    for i in range(ns):
        cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
        c = next(c for c in comps if c.id == cid)
        scan.append((c, dc_tabs[tables >> 4], ac_tabs[tables & 15]))
    ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    if ss != 0 or se != 63 or ahal != 0:
        raise NotImplementedError("JPEG: a progressive scan")
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    for c, _, _ in scan:
        if c.coef is None:
            if len(comps) == 1:
                shape = (-(-height // 8), -(-width // 8))
            else:
                shape = (mcuy * c.v, mcux * c.h)
            c.coef = np.zeros(shape + (64,), np.int64)
    if ns == 1:  # non-interleaved: the component's own blocks in raster order
        c = scan[0][0]
        mcux = -(-(-(-width * c.h // hmax)) // 8)
        mcuy = -(-(-(-height * c.v // vmax)) // 8)
        units = [[(0, 0)]]
    else:
        units = [[(v, h) for v in range(c.v) for h in range(c.h)] for c, _, _ in scan]
    # per block of an MCU: (slot, dc, ac, offset of the block's first
    # coefficient at MCU (0, 0), its step per MCU column, per MCU row)
    layout = []
    for slot, ((c, dc, ac), blocks) in enumerate(zip(scan, units)):
        cols = c.coef.shape[1]
        bh, bv = (1, 1) if ns == 1 else (c.h, c.v)
        for v, h in blocks:
            layout.append((slot, dc, ac, (v * cols + h) * 64, bh * 64, bv * cols * 64))

    def plan(m):
        my, mx = divmod(m, mcux)
        return [(slot, dc, ac, off + mx * sx + my * sy) for slot, dc, ac, off, sx, sy in layout]

    out_idx = [[] for _ in scan]
    out_val = [[] for _ in scan]
    total = mcux * mcuy
    per = restart or total
    done = 0
    while done < total:
        end = pos
        while True:  # the segment ends at the next marker that is not stuffing
            end = data.index(b"\xff", end)
            if data[end + 1] != 0x00:
                break
            end += 2
        n = min(per, total - done)
        dc_pred = [0] * len(scan)
        _decode_segment(data[pos:end], lambda m, d=done: plan(d + m), n, dc_pred, out_idx, out_val)
        done += n
        pos = end
        if done < total and 0xD0 <= data[pos + 1] <= 0xD7:
            pos += 2
    for slot, (c, _, _) in enumerate(scan):
        flat = c.coef.reshape(-1)
        flat[np.asarray(out_idx[slot], np.int64)] = np.asarray(out_val[slot], np.int64)
    return pos


# --------------------------------------------------------------------- PNG


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8)[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = rows[y, 0], rows[y, 1:]
        if ft == 0:
            cur = line.copy()
        elif ft == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ft == 2:
            cur = line + prev
        elif ft in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {ft}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced gray, RGB or RGBA PNG -> uint8 [H, W] or
    [H, W, C]."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat = 8, []
    width = height = color = 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: bad CRC in the {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            width, height, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or color not in (0, 2, 6):
                raise NotImplementedError(f"PNG: bit depth {depth}, color type {color}")
            if interlace:
                raise NotImplementedError("PNG: interlaced files")
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    channels = {0: 1, 2: 3, 6: 4}[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), height, width * channels, channels)
    img = px.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> PNG bytes,
    every row Sub-filtered, deflated at zlib's fastest level (the bench
    writes full frames on the host)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 3: 2, 4: 6}[channels]
    x = img.reshape(h, w, channels)
    sub = x.copy()
    sub[:, 1:] = x[:, 1:] - x[:, :-1]  # uint8 wraps mod 256
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub.reshape(h, w * channels)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_PNG_MAGIC + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 [H, W], [H, W, 3] (RGB) or [H, W, 4] (RGBA) as a PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
