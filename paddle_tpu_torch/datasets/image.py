"""paddle.dataset.image parity — numpy image transforms.

Reference: python/paddle/dataset/image.py (resize_short :197,
to_chw :225, center_crop :249, random_crop :277, left_right_flip
:305, simple_transform :327, load_and_transform :383).  The
reference shells out to cv2 for everything; here the transforms are
pure numpy (bilinear resize included) so they work in this image.
File loading handles .npy/.npz and binary PPM/PGM natively and uses
cv2 only if it happens to be importable.
"""

import numpy as np

__all__ = [
    "load_image", "load_image_bytes", "resize_short", "to_chw",
    "center_crop", "random_crop", "left_right_flip", "simple_transform",
    "load_and_transform",
]


def _resize_bilinear(im, out_h, out_w):
    """HWC (or HW) bilinear resize in numpy, align_corners=False
    semantics (the cv2.resize default the reference relies on)."""
    in_h, in_w = im.shape[:2]
    if (in_h, in_w) == (out_h, out_w):
        return im
    ys = (np.arange(out_h) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    if im.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    f = im.astype(np.float32)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(im.dtype, np.integer):
        out = np.clip(np.round(out), np.iinfo(im.dtype).min,
                      np.iinfo(im.dtype).max)
    return out.astype(im.dtype)


def _load_ppm(data):
    """Binary PPM (P6) / PGM (P5) decoder."""
    parts = []
    idx = 0
    while len(parts) < 4:
        nl = data.index(b"\n", idx)
        line = data[idx:nl]
        idx = nl + 1
        for tok in line.split(b"#")[0].split():
            parts.append(tok)
    magic, w, h, maxv = parts[0], int(parts[1]), int(parts[2]), int(parts[3])
    assert maxv <= 255, "16-bit PPM not supported"
    raw = np.frombuffer(data[idx:], np.uint8)
    if magic == b"P6":
        return raw[:w * h * 3].reshape(h, w, 3)
    if magic == b"P5":
        return raw[:w * h].reshape(h, w)
    raise ValueError("unsupported netpbm magic %r" % magic)


def load_image_bytes(bytes, is_color=True):
    if bytes[:2] in (b"P6", b"P5"):
        im = _load_ppm(bytes)
    else:
        try:
            import cv2

            flag = 1 if is_color else 0
            im = cv2.imdecode(np.frombuffer(bytes, np.uint8), flag)
        except ImportError:
            raise RuntimeError(
                "only PPM/PGM/npy images decode without cv2 in this "
                "environment") from None
    if is_color and im.ndim == 2:
        im = np.repeat(im[..., None], 3, axis=-1)
    if not is_color and im.ndim == 3:
        im = im.mean(axis=-1).astype(im.dtype)
    return im


def load_image(file, is_color=True):
    if file.endswith((".npy", ".npz")):
        arr = np.load(file)
        im = arr["image"] if hasattr(arr, "files") else arr
        if is_color and im.ndim == 2:
            im = np.repeat(im[..., None], 3, axis=-1)
        return im
    with open(file, "rb") as f:
        return load_image_bytes(f.read(), is_color=is_color)


def resize_short(im, size):
    """Scale so the SHORTER edge becomes `size` (image.py:197)."""
    h, w = im.shape[:2]
    if h < w:
        return _resize_bilinear(im, size, int(round(w * size / h)))
    return _resize_bilinear(im, int(round(h * size / w)), size)


def to_chw(im, order=(2, 0, 1)):
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    return im[h_start:h_start + size, w_start:w_start + size]


def random_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h_start = np.random.randint(0, h - size + 1)
    w_start = np.random.randint(0, w - size + 1)
    return im[h_start:h_start + size, w_start:w_start + size]


def left_right_flip(im, is_color=True):
    if len(im.shape) == 3 and is_color:
        return im[:, ::-1, :]
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """resize_short -> crop (random+flip when training, center
    otherwise) -> CHW -> optional mean subtraction (image.py:327)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color=is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color=is_color)
    if len(im.shape) == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.array(mean, dtype=np.float32)
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean[:, None, None]
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    im = load_image(filename, is_color)
    return simple_transform(im, resize_size, crop_size, is_train,
                            is_color, mean)
