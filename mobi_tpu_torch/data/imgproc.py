"""cv2's image operations that the data path and the test bench call, in numpy.

The port does not depend on cv2, so it keeps its own versions, each written to
give cv2 5.0's output (the tests hold them against cv2):

  * `resize_linear` (INTER_LINEAR: half-pixel centres, edge clamp; uint8
    through cv2's 11-bit fixed-point coefficients and its vector rounding),
    `resize_nearest` (INTER_NEAREST);
  * `fill_poly_aa` (`fillPoly(..., LINE_AA)`: every edge drawn as cv2's
    anti-aliased line, then the scanline fill of the interior) and
    `fill_poly` (`fillPoly` with LINE_8: every edge as cv2's 8-connected
    line, then the same scanline fill, an edge off the image along its
    clipped ends);
  * `line` (`line(..., thickness=1)`, LINE_8 or LINE_AA, one or three
    channels) and `arrowed_line` (`arrowedLine`, its tip's two strokes at
    cvRound-ed ends);
  * `gaussian_blur`, `dilate`, `box_blur` (reflect-101 borders where cv2 has
    them), `get_rotation_matrix_2d`, `warp_affine_linear` (`warpAffine`,
    bilinear, constant border, uint8 and float32, in the float32
    arithmetic with fused multiply-adds of cv2's vector loop and its
    scalar tail) and `rotate` (a uint8 image about its centre);
  * `TURBO_LUT` (COLORMAP_TURBO as RGB) and `fill_circle` (`circle(...,
    thickness=-1)` with 8-connected lines).

And one of Pillow's, since the port does not depend on PIL either:
`resize_bicubic_pil`, `Image.resize(..., BICUBIC)` bit for bit (CLIP's
preprocess; the tests hold it against Pillow 12).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

TURBO_LUT = np.frombuffer(bytes.fromhex(
    "30123b32154333184a341b51351e5836215f37246638276d392a733a2d793b2f803c32863d358b3e38913f3b973f3e9c"
    "4040a24143a74146ac4249b1424bb5434eba4451bf4454c34456c74559cb455ccf455ed34661d64664da4666dd4669e0"
    "466be3476ee64771e94773eb4776ee4778f0477bf2467df44680f64682f84685fa4687fb458afc458cfd448ffe4391fe"
    "4294ff4196ff4099ff3e9bfe3d9efe3ba0fd3aa3fc38a5fb37a8fa35abf833adf731aff52fb2f42eb4f22cb7f02ab9ee"
    "28bceb27bee925c0e723c3e422c5e220c7df1fc9dd1ecbda1ccdd81bd0d51ad2d21ad4d019d5cd18d7ca18d9c818dbc5"
    "18ddc218dec018e0bd19e2bb19e3b91ae4b61ce6b41de7b21fe9af20eaac22ebaa25eca727eea42aefa12cf09e2ff19b"
    "32f29835f39438f4913cf58e3ff68a43f78746f8844af8804ef97d52fa7a55fa7659fb735dfc6f61fc6c65fd6969fd66"
    "6dfe6271fe5f75fe5c79fe597dff5680ff5384ff5188ff4e8bff4b8fff4992ff4796fe4499fe429cfe409ffd3fa1fd3d"
    "a4fc3ca7fc3aa9fb39acfb38affa37b1f936b4f836b7f735b9f635bcf534bef434c1f334c3f134c6f034c8ef34cbed34"
    "cdec34d0ea34d2e935d4e735d7e535d9e436dbe236dde037dfdf37e1dd37e3db38e5d938e7d739e9d539ebd339ecd13a"
    "eecf3aefcd3af1cb3af2c93af4c73af5c53af6c33af7c13af8be39f9bc39faba39fbb838fbb637fcb336fcb136fdae35"
    "fdac34fea933fea732fea431fea130fe9e2ffe9b2dfe992cfe962bfe932afe9029fd8d27fd8a26fc8725fc8423fb8122"
    "fb7e21fa7b1ff9781ef9751df8721cf76f1af66c19f56918f46617f36315f26014f15d13f05b12ef5811ed5510ec530f"
    "eb500eea4e0de84b0ce7490ce5470be4450ae2430ae14109df3f08dd3d08dc3b07da3907d83706d63506d43305d23105"
    "d02f05ce2d04cc2b04ca2a04c82803c52603c32503c12302be2102bc2002b91e02b71d02b41b01b21a01af1801ac1701"
    "a91601a71401a41301a112019e10019b0f01980e01950d01920b018e0a018b09028808028507028106027e05027a0403"), np.uint8).reshape(256, 3)


# ------------------------------------------------------------------ resizes


def _taps(src: int, dst: int, fixed_point: bool, columns: bool):
    """cv2's two source indices and the weight of the second per destination
    index (resize.cpp): f = (d + 0.5) * scale - 0.5, s = floor(f), both
    indices clamped to the source; a column's weight is set to 0 where s
    leaves it, a row's is kept. The uint8 path rounds f to float32 first,
    the float path keeps it in float64."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5
    if fixed_point:
        f = f.astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(f.dtype)
    if columns:
        f[(s < 0) | (s >= src - 1)] = 0
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f


def resize_linear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) for [H, W] or
    [H, W, C] uint8, float32 or float64 arrays."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    x = img if img.ndim == 3 else img[..., None]
    fixed = img.dtype == np.uint8
    sx0, sx1, fx = _taps(W, w, fixed, columns=True)
    sy0, sy1, fy = _taps(H, h, fixed, columns=False)
    if fixed:
        one = np.float32(2048)  # INTER_RESIZE_COEF_SCALE
        ax0 = np.rint((np.float32(1) - fx) * one).astype(np.int64)[None, :, None]
        ax1 = np.rint(fx * one).astype(np.int64)[None, :, None]
        b0 = np.rint((np.float32(1) - fy) * one).astype(np.int64)[:, None, None]
        b1 = np.rint(fy * one).astype(np.int64)[:, None, None]
        xi = x.astype(np.int64)
        rows = xi[:, sx0] * ax0 + xi[:, sx1] * ax1
        # the vector path (VResizeLinearVec_32s8u): 16-bit multiply-high of
        # the rows shifted right by 4, then a rounding shift by 2
        out = ((((rows[sy0] >> 4) * b0) >> 16) + (((rows[sy1] >> 4) * b1) >> 16) + 2) >> 2
        out = np.clip(out, 0, 255).astype(np.uint8)
    else:
        ft = np.float64 if img.dtype == np.float64 else np.float32
        xf = x.astype(ft)
        fx, fy = fx.astype(ft), fy.astype(ft)
        rows = xf[:, sx0] * (1 - fx)[None, :, None] + xf[:, sx1] * fx[None, :, None]
        out = rows[sy0] * (1 - fy)[:, None, None] + rows[sy1] * fy[:, None, None]
        out = out.astype(ft)
    return out if img.ndim == 3 else out[..., 0]


def resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_NEAREST): source index
    floor(d * src / dst), clamped; any dtype."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    sy = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(np.int64), H - 1)
    sx = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(np.int64), W - 1)
    return img[sy][:, sx]


_PIL_PRECISION_BITS = 32 - 8 - 2  # Resample.c: 8 bits of result, 2 of headroom


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    """Resample.c's bicubic_filter (a = -0.5), in its evaluation order."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _pil_coeffs(in_size: int, out_size: int):
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc for the whole
    input (box 0..in_size): the first source index and the count of each
    output's taps, and their int coefficients [out_size, ksize] (0 past the
    count). On a downscale the support widens by the scale (antialiasing)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    live = x[None, :] < xmax[:, None]
    w = np.where(live, _pil_bicubic(((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale)),
                 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # the C loop's left-to-right sum
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    one = float(1 << _PIL_PRECISION_BITS)
    k = np.trunc(np.where(w < 0, -0.5 + w * one, 0.5 + w * one)).astype(np.int64)
    return xmin, xmax, np.where(live, k, 0)


def _pil_pass(img: np.ndarray, in_size: int, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of Resample.c along `axis` (1: horizontal, 0:
    vertical): a half-ulp offset, the integer taps, then clip8 (an
    arithmetic shift by PRECISION_BITS, clamped to 0..255)."""
    xmin, xmax, k = _pil_coeffs(in_size, out_size)
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:], 1 << (_PIL_PRECISION_BITS - 1), np.int64)
    src = img.astype(np.int64)
    kshape = (1,) * axis + (out_size,) + (1,) * (img.ndim - axis - 1)
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, in_size - 1)  # taps past the count weigh 0
        acc += np.take(src, idx, axis=axis) * k[:, j].reshape(kshape)
    return np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic_pil(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Pillow's `Image.resize((w, h), Image.BICUBIC)` (reducing_gap None, no
    box) for uint8 [H, W] (mode L) and [H, W, 3] (RGB) arrays, bit for bit:
    Resample.c's two passes, horizontal first, its uint8 result clipped,
    then vertical; a pass whose size does not change is skipped, and an
    unchanged size is a copy. (Pillow runs the horizontal pass over only
    the rows the vertical one reads; the other rows are never used.)

    RGBA is not taken: Pillow premultiplies alpha before resampling, and
    the port's `read_image` drops alpha when it reads a file."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"resize_bicubic_pil takes uint8 [H, W] or [H, W, 3], not {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    out = img.copy()
    if W != w:
        out = _pil_pass(out, W, w, axis=1)
    if H != h:
        out = _pil_pass(out, H, h, axis=0)
    return out


# ------------------------------------------------------------------ filters


def _reflect101(x: np.ndarray, r: int, axis: int) -> np.ndarray:
    n = x.shape[axis]
    idx = np.abs(np.arange(-r, n + r))
    idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
    return np.take(x, idx, axis=axis)


def _gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(n, sigma) in float64."""
    x = np.arange(n) - (n - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return k / k.sum()


def gaussian_blur(x: np.ndarray, ksize: int = 15, sigma: float = 7.0) -> np.ndarray:
    """cv2.GaussianBlur(x, (ksize, ksize), sigma) of a float [H, W] array,
    BORDER_REFLECT_101, separable, summed in float64."""
    k = _gaussian_kernel(ksize, sigma)
    r = ksize // 2
    H, W = x.shape[:2]
    p = _reflect101(_reflect101(np.asarray(x, np.float64), r, 0), r, 1)
    t = sum(k[i] * p[i:i + H] for i in range(ksize))
    out = sum(k[i] * t[:, i:i + W] for i in range(ksize))
    return out.astype(x.dtype)


def dilate(x: np.ndarray, k: int = 5) -> np.ndarray:
    """cv2.dilate(x, np.ones((k, k), np.uint8)): the max over a k x k window;
    the border adds nothing."""
    x = np.asarray(x)
    r = k // 2
    H, W = x.shape[:2]
    low = -np.inf if x.dtype.kind == "f" else np.iinfo(x.dtype).min
    p = np.pad(x, ((r, r), (r, r)) + ((0, 0),) * (x.ndim - 2), constant_values=low)
    return np.max([p[i:i + H, j:j + W] for i in range(k) for j in range(k)], axis=0).astype(x.dtype)


def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """cv2.blur(img, (k, k)) of a uint8 image: the k x k mean, rounded,
    BORDER_REFLECT_101."""
    r = k // 2
    H, W = img.shape[:2]
    p = _reflect101(_reflect101(img.astype(np.int64), r, 0), r, 1)
    c = np.pad(p, ((1, 0), (1, 0)) + ((0, 0),) * (img.ndim - 2)).cumsum(0).cumsum(1)
    s = c[k:k + H, k:k + W] - c[:H, k:k + W] - c[k:k + H, :W] + c[:H, :W]
    return np.clip(np.rint(s / (k * k)), 0, 255).astype(np.uint8)


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once, as a fused multiply-add."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def get_rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: the 2 x 3 float64 matrix that rotates by
    `angle` degrees (counter-clockwise) about `center` and scales."""
    a = angle * (np.pi / 180)  # cv2: angle *= CV_PI / 180
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def warp_affine_linear(img: np.ndarray, matrix: np.ndarray, size: Tuple[int, int],
                       border_value: float = 0.0) -> np.ndarray:
    """cv2.warpAffine(img, matrix, size=(w, h), flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=border_value) of an [H, W] or
    [H, W, C] uint8 or float32 image, as cv2 5.0 computes it: the inverted
    matrix in float32, each destination pixel's source coordinates in
    float32 with cv2's fused multiply-adds (x * M0 + (y * M1 + M2) in its
    vectors of 16 columns, fma(x, M0, y * M1) + M2 in the scalar loop over
    the last w % 16; no quantisation to 1/32 of a pixel), the four taps
    outside the source read as `border_value`, the bilinear blend in float32
    fma. float32 comes out as computed; uint8 is rounded to nearest even and
    saturated."""
    w, h = size
    H, W = img.shape[:2]
    m = [float(v) for v in np.asarray(matrix, np.float64).reshape(6)]
    # warpAffine inverts the forward map (imgwarp.cpp)
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    m = np.asarray(m, np.float64).astype(np.float32)
    f32 = np.float32
    xs = np.broadcast_to(np.arange(w, dtype=f32)[None], (h, w))
    ys = np.broadcast_to(np.arange(h, dtype=f32)[:, None], (h, w))
    vec = np.arange(w) < w // 16 * 16  # cv2's vector columns; the rest is its scalar tail
    sx = np.where(vec, _fma32(xs, m[0], ys * m[1] + m[2]), _fma32(xs, m[0], ys * m[1]) + m[2])
    sy = np.where(vec, _fma32(xs, m[3], ys * m[4] + m[5]), _fma32(xs, m[3], ys * m[4]) + m[5])
    ix, iy = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    x = img.astype(f32)
    if x.ndim == 2:
        x = x[..., None]

    def fetch(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        return np.where(ok[..., None], x[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)], f32(border_value))

    p00, p01, p10, p11 = fetch(iy, ix), fetch(iy, ix + 1), fetch(iy + 1, ix), fetch(iy + 1, ix + 1)
    ax = np.broadcast_to((sx - ix.astype(f32))[..., None], p00.shape)
    ay = np.broadcast_to((sy - iy.astype(f32))[..., None], p00.shape)
    v0 = _fma32(ax, p01 - p00, p00)
    v1 = _fma32(ax, p11 - p10, p10)
    out = _fma32(ay, v1 - v0, v0)
    if img.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.reshape((h, w) + img.shape[2:])


def rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """cv2.warpAffine(img, cv2.getRotationMatrix2D((w / 2, h / 2), angle,
    1.0), (w, h), borderMode=BORDER_CONSTANT, borderValue=0) of a uint8
    image, equal to cv2 5.0 at every width (`warp_affine_linear`). The
    tests hold it against the cv2 5.0 found where they run; cv2 4.13 (on
    the card's host) has other uint8 warp kernels, which may round
    differently."""
    H, W = img.shape[:2]
    return warp_affine_linear(img, get_rotation_matrix_2d((W / 2, H / 2), angle, 1.0), (W, H))


# --------------------------------------------------------- anti-aliased fill

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# drawing.cpp's tables of LineAA: the weight by the line's slope, and the
# filter by the distance of a pixel's centre from the line in 1/32 pixel
_SLOPE_CORR = (181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196, 198, 201,
               203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238, 242, 246, 250, 254)
_FILTER = np.array((
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254, 254,
    254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185, 177, 168,
    158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75, 68, 62, 56, 50, 45,
    40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7, 5, 5), np.int64)


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine on a w x h box; None where the line misses it."""
    x1, y1, x2, y2, inside = _clip_ends(w, h, x1, y1, x2, y2)
    return (x1, y1, x2, y2) if inside else None


def _clip_ends(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine's ends and its result: (x1, y1, x2, y2, inside); where
    the line misses the box the ends are as cv2 leaves them, moved part
    of the way or not at all."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return x1, y1, x2, y2, not (c1 | c2)


def _line_aa(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """cv2's LineAA on a uint8 image of one channel or three, endpoints in
    1/65536 pixel: three pixels across the line at each step along its
    major axis, each channel blended twice, as cv2's ICV_PUT_POINT does:
    v += ((color - v) * a + 127) >> 8, then again from the new v. (On a 0/1
    mask drawn with 1 the second blend changes nothing.)"""
    H, W = img.shape[:2]
    color = np.asarray(color, np.int64)
    if img.ndim == 3:
        color = np.broadcast_to(color, img.shape[2:])
    clipped = _clip_line(W << XY_SHIFT, H << XY_SHIFT, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    x_major = abs(dx) > abs(dy)
    if x_major:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _trunc_div(dy << XY_SHIFT, abs(dx) | 1)
        lo, hi, minor = x1, x2, y1
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _trunc_div(dx << XY_SHIFT, abs(dy) | 1)
        lo, hi, minor = y1, y2, x1
    hi += XY_ONE
    ecount = (hi >> XY_SHIFT) - (lo >> XY_SHIFT)
    minor += ((step * -(lo & (XY_ONE - 1))) >> XY_SHIFT) + (XY_ONE >> 1)
    slope = (step >> (XY_SHIFT - 5)) & 0x3F
    slope ^= 0x3F if step < 0 else 0
    slope = 0x100 if slope & 0x20 else _SLOPE_CORR[slope]
    i = (lo >> (XY_SHIFT - 7)) & 0x78  # the endpoints' 4-bit fractions
    j = (hi >> (XY_SHIFT - 7)) & 0x78
    t0, t1, t2 = slope << 7, ((0x78 - i) | 4) * slope, (j | 4) * slope
    ep = np.array([0, ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF, (t1 >> 8) & 0x1FF,
                   ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF, ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1FF,
                   ((t1 + t0) >> 8) & 0x1FF, (t2 >> 8) & 0x1FF, ((t2 + t0) >> 8) & 0x1FF, slope], np.int64)
    s = np.arange(ecount + 1, dtype=np.int64)
    e = ecount - s
    corr = ep[(((s >= 2) + 1) & (s | 2)) * 3 + (((e >= 2) + 1) & (e | 2))]
    major = (lo >> XY_SHIFT) + s
    pos = minor + s * step
    base = (pos >> XY_SHIFT) - 1
    dist = (pos >> (XY_SHIFT - 5)) & 31
    n_major, n_minor = (W, H) if x_major else (H, W)
    for off, fidx in ((0, dist + 32), (1, dist), (2, 63 - dist)):
        a = (corr * _FILTER[fidx] >> 8) & 0xFF
        mn = base + off
        ok = (major >= 0) & (major < n_major) & (mn >= 0) & (mn < n_minor)
        rows, cols = (mn[ok], major[ok]) if x_major else (major[ok], mn[ok])
        v = img[rows, cols].astype(np.int64)
        w = a[ok] if img.ndim == 2 else a[ok][:, None]
        v = v + (((color - v) * w + 127) >> 8)
        img[rows, cols] = v + (((color - v) * w + 127) >> 8)


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """cv2's Line with LINE_8 (its LineIterator, left to right, clipped to
    the image first): Bresenham along the major axis, a minor step wherever
    the error is negative."""
    H, W = img.shape[:2]
    if not (0 <= x1 < W and 0 <= x2 < W and 0 <= y1 < H and 0 <= y2 < H):
        clipped = _clip_line(W, H, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, abs(y2 - y1), (1 if y2 >= y1 else -1)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    xs, ys = np.empty(dx + 1, np.int64), np.empty(dx + 1, np.int64)
    x, y = x1, y1
    for i in range(dx + 1):
        xs[i], ys[i] = x, y
        minor = err < 0
        err += 2 * dx - 2 * dy if minor else -2 * dy
        if vert:
            y, x = y + sy, x + minor
        else:
            x, y = x + 1, y + sy * minor
    img[ys, xs] = color


def line(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int], color,
         line_type: int = 8) -> np.ndarray:
    """cv2.line(img, pt1, pt2, color, 1, line_type) in place on a uint8 image
    of one channel or three: LINE_8 (8) or LINE_AA (16)."""
    (x1, y1), (x2, y2) = ((int(x), int(y)) for x, y in (pt1, pt2))
    if line_type == 16:
        _line_aa(img, x1 << XY_SHIFT, y1 << XY_SHIFT, x2 << XY_SHIFT, y2 << XY_SHIFT, color)
    elif line_type == 8:
        _line8(img, x1, y1, x2, y2, color)
    else:
        raise NotImplementedError(f"line_type {line_type}: the port draws LINE_8 and LINE_AA")
    return img


def arrowed_line(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int], color,
                 line_type: int = 8, tip_length: float = 0.1) -> np.ndarray:
    """cv2.arrowedLine(img, pt1, pt2, color, 1, line_type, 0, tip_length) in
    place: the shaft, then two strokes from pt2 at +-45 degrees about the
    reversed direction, tip_length of the shaft long, their ends rounded
    half to even (cvRound)."""
    (x1, y1), (x2, y2) = ((int(x), int(y)) for x, y in (pt1, pt2))
    tip = np.hypot(x1 - x2, y1 - y2) * tip_length
    angle = np.arctan2(float(y1 - y2), float(x1 - x2))
    line(img, (x1, y1), (x2, y2), color, line_type)
    for turn in (np.pi / 4, -np.pi / 4):
        p = (int(np.rint(x2 + tip * np.cos(angle + turn))), int(np.rint(y2 + tip * np.sin(angle + turn))))
        line(img, p, (x2, y2), color, line_type)
    return img


def _fill_edges(img: np.ndarray, edges, color: int) -> None:
    """cv2's FillEdgeCollection. An edge (x, dx, y0, y1) is active on rows
    [y0, y1), at x + (y - y0) * dx there (cv2 adds dx once a row to every
    active edge); each row's active edges, sorted by x, pair up into spans
    from the ceiling of the left edge to the floor of the right. cv2 walks
    the rows above the image too, drawing nothing there; this starts at row
    0."""
    H, W = img.shape[:2]
    if len(edges) < 2:
        return
    x, dx, y0, y1 = (np.array(v, np.int64) for v in zip(*edges))
    ends = np.concatenate([x, x + (y1 - y0) * dx])
    if y1.max() < 0 or y0.min() >= H or ends.max() < 0 or ends.min() >= (W << XY_SHIFT):
        return
    for y in range(max(int(y0.min()), 0), min(int(y1.max()), H)):
        on = (y0 <= y) & (y < y1)
        xs = np.sort(x[on] + (y - y0[on]) * dx[on])
        for left, right in zip((xs[0::2] + XY_ONE - 1) >> XY_SHIFT, xs[1::2] >> XY_SHIFT):
            if left < W and right >= 0:
                img[y, max(left, 0):min(right, W - 1) + 1] = color


def fill_poly_aa(mask: np.ndarray, pts, color: int = 1) -> np.ndarray:
    """cv2.fillPoly(mask, [pts], color, cv2.LINE_AA) on a one-channel uint8
    image, in place: each edge as cv2's anti-aliased line, then the
    interior. On a 0/1 mask with color 1 an edge pixel is set where its
    alpha a has (a + 127) >> 8 = 1."""
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []
    x0, y0 = pts[-1][0] << XY_SHIFT, pts[-1][1]
    for px, py in pts:
        x1, y1 = px << XY_SHIFT, py
        _line_aa(mask, x0, y0 << XY_SHIFT, x1, y1 << XY_SHIFT, color)
        if y0 != y1:
            dx = _trunc_div(x1 - x0, y1 - y0)
            edges.append((x0, dx, y0, y1) if y0 < y1 else (x1, dx, y1, y0))
        x0, y0 = x1, y1
    _fill_edges(mask, edges, color)
    return mask


def fill_poly(mask: np.ndarray, pts, color: int = 1) -> np.ndarray:
    """cv2.fillPoly(mask, [pts], color) (LINE_8) on a one-channel uint8
    image, in place: each edge as cv2's 8-connected line, then the scanline
    fill of `fill_poly_aa`. An edge with an end off the image runs, over its
    whole height, along the line through its ends as clipLine leaves them
    (vertical where they share a row): cv2 5.0's CollectPolyEdges, found by
    holding random polygons against it."""
    H, W = mask.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        _line8(mask, x0, y0, x1, y1, color)
        c0, c1 = (x0, y0), (x1, y1)
        if not (0 <= x0 < W and 0 <= x1 < W and 0 <= y0 < H and 0 <= y1 < H):
            # the ends as clipLine leaves them, whether it found the line or not
            cx0, cy0, cx1, cy1, _ = _clip_ends(W, H, x0, y0, x1, y1)
            c0, c1 = (cx0, cy0), (cx1, cy1)
        c0, c1 = [c0[0] << XY_SHIFT, c0[1]], [c1[0] << XY_SHIFT, c1[1]]
        if y0 != y1:
            # ends clipped to one row make a vertical edge through them
            dx = _trunc_div(c1[0] - c0[0], c1[1] - c0[1]) if c1[1] != c0[1] else 0
            if y0 < y1:
                edges.append((c0[0] + (y0 - c0[1]) * dx, dx, y0, y1))
            else:
                edges.append((c1[0] + (y1 - c1[1]) * dx, dx, y1, y0))
        x0, y0 = x1, y1
    _fill_edges(mask, edges, color)
    return mask


# ---------------------------------------------------------------- overlays


def fill_circle(img: np.ndarray, center: Tuple[int, int], radius: int, color: Sequence[int]) -> np.ndarray:
    """cv2.circle(img, center, radius, color, -1) (LINE_8, no shift), in
    place: the midpoint circle's rows filled as horizontal spans."""
    H, W = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    color = np.asarray(color, img.dtype)
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1

    def span(y, x1, x2):
        if 0 <= y < H and x1 < W and x2 >= 0:
            img[y, max(x1, 0):min(x2, W - 1) + 1] = color

    while dx >= dy:
        span(cy - dy, cx - dx, cx + dx)
        span(cy + dy, cx - dx, cx + dx)
        span(cy - dx, cx - dy, cx + dy)
        span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img
