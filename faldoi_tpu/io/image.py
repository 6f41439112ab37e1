"""Image I/O with the reference's iio semantics.

``iio_read_image_float_split`` returns planar float32 channels with values in
the file's native range (0..255 for 8-bit PNG).  Binary PPM/PGM frames and
PFM float maps are read and written with NumPy alone; PNG and TIFF go
through PIL / imageio, imported only when such a file is touched, so the
pipeline runs where neither is installed.  ``rgb_to_gray`` matches
``energy_model.cpp:45-54`` / ``global_faldoi.cpp:1820-1827`` (ITU-R 601
luma, computed in float64 then stored as float32, exactly like the C
double-promoted expression).
"""

from __future__ import annotations

import numpy as np

_NETPBM = (".ppm", ".pgm", ".pnm")
_TIFF = (".tif", ".tiff")


def _read_header(fh, n):
    """Read ``n`` whitespace-separated header tokens (``#`` comments
    skipped); consumes exactly one whitespace byte after the last token."""
    toks, tok = [], b""
    while len(toks) < n:
        c = fh.read(1)
        if not c:
            raise ValueError("truncated image header")
        if c == b"#":
            fh.readline()
        elif c.isspace():
            if tok:
                toks.append(tok.decode())
                tok = b""
        else:
            tok += c
    return toks


def read_netpbm(path: str) -> np.ndarray:
    """Binary PGM (P5) / PPM (P6), 8-bit -> float32 (h, w[, 3])."""
    with open(path, "rb") as fh:
        magic, w, h, maxval = _read_header(fh, 4)
        if magic not in ("P5", "P6") or int(maxval) > 255:
            raise ValueError(f"{path}: only 8-bit binary P5/P6 is supported")
        nch = 3 if magic == "P6" else 1
        w, h = int(w), int(h)
        data = np.frombuffer(fh.read(w * h * nch), np.uint8)
    if data.size != w * h * nch:
        raise ValueError(f"{path}: truncated pixel data")
    shape = (h, w, 3) if nch == 3 else (h, w)
    return data.reshape(shape).astype(np.float32)


def write_netpbm(path: str, img: np.ndarray) -> None:
    """(h, w) or (h, w, 3) values in 0..255 -> binary PGM / PPM."""
    arr = np.clip(np.rint(np.asarray(img)), 0, 255).astype(np.uint8)
    magic = b"P6" if arr.ndim == 3 else b"P5"
    with open(path, "wb") as fh:
        fh.write(magic + f"\n{arr.shape[1]} {arr.shape[0]}\n255\n".encode())
        fh.write(np.ascontiguousarray(arr).tobytes())


def read_pfm(path: str) -> np.ndarray:
    """PFM float map -> float32 (h, w[, 3]), rows top to bottom."""
    with open(path, "rb") as fh:
        magic, w, h, scale = _read_header(fh, 4)
        if magic not in ("Pf", "PF"):
            raise ValueError(f"{path}: not a PFM file")
        nch = 3 if magic == "PF" else 1
        w, h = int(w), int(h)
        dt = "<f4" if float(scale) < 0 else ">f4"
        data = np.frombuffer(fh.read(4 * w * h * nch), dt)
    if data.size != w * h * nch:
        raise ValueError(f"{path}: truncated pixel data")
    shape = (h, w, 3) if nch == 3 else (h, w)
    return np.flipud(data.reshape(shape)).astype(np.float32)


def write_pfm(path: str, img: np.ndarray) -> None:
    """(h, w) or (h, w, 3) float map -> little-endian PFM."""
    arr = np.asarray(img, np.float32)
    magic = b"PF" if arr.ndim == 3 else b"Pf"
    with open(path, "wb") as fh:
        fh.write(magic + f"\n{arr.shape[1]} {arr.shape[0]}\n-1.0\n".encode())
        fh.write(np.ascontiguousarray(np.flipud(arr), "<f4").tobytes())


def read_image_split(path: str) -> np.ndarray:
    """Read an image as float32 planar channels, shape (pd, h, w)."""
    lower = path.lower()
    if lower.endswith(".flo"):
        from faldoi_tpu.io.flo import read_flo

        f = read_flo(path)
        return np.ascontiguousarray(f.transpose(2, 0, 1)).astype(np.float32)
    if lower.endswith(_NETPBM):
        arr = read_netpbm(path)
    elif lower.endswith(".pfm"):
        arr = read_pfm(path)
    elif lower.endswith(_TIFF):
        import imageio.v3 as iio

        arr = np.asarray(iio.imread(path)).astype(np.float32)
    else:
        from PIL import Image

        arr = np.asarray(Image.open(path)).astype(np.float32)
    if arr.ndim == 2:
        return arr[None]
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


def read_image_gray(path: str) -> np.ndarray:
    """Read an image and collapse to grayscale (h, w) with ITU-R 601 luma."""
    planes = read_image_split(path)
    if planes.shape[0] == 1:
        return planes[0]
    return rgb_to_gray(planes)


def rgb_to_gray(planes: np.ndarray) -> np.ndarray:
    """(pd, h, w) planar RGB(A) -> (h, w) gray. Matches energy_model.cpp:45-54.

    The C code computes ``.299*r + .587*g + .114*b`` with double literals, so
    the accumulation happens in float64 before the float32 store; we do the
    same to stay bit-close.
    """
    r = planes[0].astype(np.float64)
    g = planes[1].astype(np.float64)
    b = planes[2].astype(np.float64)
    return (0.299 * r + 0.587 * g + 0.114 * b).astype(np.float32)


def save_image_float(path: str, img: np.ndarray) -> None:
    """Save a float image (single channel: the energy map).  ``.pfm`` needs
    only NumPy; TIFF goes through imageio, anything else through PIL."""
    img = np.asarray(img, dtype=np.float32)
    lower = path.lower()
    if lower.endswith(".flo"):
        raise ValueError("use write_flo for .flo files")
    if lower.endswith(".pfm"):
        write_pfm(path, img)
    elif lower.endswith(_TIFF):
        import imageio.v3 as iio

        iio.imwrite(path, img)
    else:
        from PIL import Image

        Image.fromarray(img).save(path)


def save_image_int(path: str, img: np.ndarray) -> None:
    """Save an int image (occlusion masks as PNG; matches iio_save_image_int).
    ``.pgm`` needs only NumPy."""
    arr = np.asarray(img)
    if path.lower().endswith(_NETPBM):
        write_netpbm(path, arr)
        return
    from PIL import Image

    arr = arr.astype(np.uint8) if arr.max(initial=0) <= 255 else arr.astype(np.int32)
    Image.fromarray(arr).save(path)
