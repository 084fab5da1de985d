"""The port's ``ImageWriter`` (``writers.encode_image``) against the
reference's, which is ``cv2.imwrite`` (``tmlibrary_tpu/writers.py``),
on the CPU.

Every suffix the port writes (``.png``, ``.tif``/``.tiff``,
``.jpg``/``.jpeg``/``.jpe``, ``.bmp``/``.dib``, ``.pbm``/``.pgm``/``.ppm``/
``.pnm``) takes the arrays ``cv2.imwrite`` takes (grey, BGR and BGRA of
every depth numpy and cv2 share, 1-channel 3-D arrays): a JPEG's bytes
equal cv2's (libjpeg-turbo 3.1.2 at quality 95: grey and 4:2:0 colour,
sizes that are not multiples of 16, uint16 and float saturated to uint8
first, BGRA without its alpha), every other file decodes (through cv2
and the port's readers) to what cv2's own file of the same array decodes
to.  Where cv2 refuses (returns False or raises) the port raises
``IOError``; the suffixes cv2 writes and the port does not raise
``NotSupportedError`` naming the suffix.  Shapes at most 37x53.
"""

import cv2
import numpy as np
import pytest
import torch

from tmlibrary_tpu import readers as j_readers
from tmlibrary_tpu.writers import ImageWriter as JImageWriter
from tmlibrary_tpu_torch import native, readers
from tmlibrary_tpu_torch.errors import NotSupportedError
from tmlibrary_tpu_torch.writers import UNPORTED_SUFFIXES, ImageWriter, saturate_u8

torch.set_num_threads(1)

SUFFIXES = [".png", ".tif", ".tiff", ".jpg", ".jpeg", ".jpe", ".bmp", ".dib", ".pbm", ".pgm",
            ".ppm", ".pnm"]


def arrays(shape) -> dict:
    """Seeded images of every kind ``cv2.imwrite`` takes or refuses."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    h, w = shape
    out = {
        "grey u8": rng.integers(0, 256, (h, w)).astype(np.uint8),
        "grey u16": rng.integers(0, 1 << 16, (h, w)).astype(np.uint16),
        "BGR u8": rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
        "BGRA u8": rng.integers(0, 256, (h, w, 4)).astype(np.uint8),
        "BGR u16": rng.integers(0, 1 << 16, (h, w, 3)).astype(np.uint16),
        "BGRA u16": rng.integers(0, 1 << 16, (h, w, 4)).astype(np.uint16),
        "grey f32": (rng.random((h, w)) * 300 - 20).astype(np.float32),
        "BGR f32": (rng.random((h, w, 3)) * 300 - 20).astype(np.float32),
        "grey f64": rng.random((h, w)) * 300 - 20,
        "grey f16": (rng.random((h, w)) * 300).astype(np.float16),
        "grey i8": rng.integers(-128, 128, (h, w)).astype(np.int8),
        "grey i16": rng.integers(-400, 400, (h, w)).astype(np.int16),
        "grey i32": rng.integers(-400, 400, (h, w)).astype(np.int32),
        "grey u32": rng.integers(0, 400, (h, w)).astype(np.uint32),
        "grey bool": rng.random((h, w)) > 0.5,
        "grey (H, W, 1)": rng.integers(0, 256, (h, w, 1)).astype(np.uint8),
        "2 channels": rng.integers(0, 256, (h, w, 2)).astype(np.uint8),
    }
    if h * w >= 9:  # the float edges cvRound meets: halves, NaN, infinities, 2^31
        edge = out["grey f32"].ravel()
        edge[:9] = [-1.5, 0.5, 1.5, 2.5, 254.5, 255.5, np.nan, np.inf, 3e9]
    return out


def cv2_write(path, img):
    try:
        return cv2.imwrite(str(path), img)
    except cv2.error:
        return False


@pytest.mark.parametrize("suffix", SUFFIXES)
@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (16, 16), (37, 53)])
def test_every_write_reads_back_as_cv2s(tmp_path, suffix, shape):
    """Each array of :func:`arrays` written by the port and by cv2 (the
    reference's ``ImageWriter`` too): JPEG bytes equal, every other file
    decoded equal by cv2, and by the port's ``ImageReader`` to the
    reference's on cv2's file; cv2's refusals raise ``IOError``."""
    for name, img in arrays(shape).items():
        mine, theirs = tmp_path / f"p{suffix}", tmp_path / f"c{suffix}"
        ok = cv2_write(theirs, img)
        if not ok:
            with pytest.raises(IOError):
                ImageWriter(mine).write(img)
            with pytest.raises(Exception):
                JImageWriter(theirs).write(img)
            continue
        ImageWriter(mine).write(img)
        if suffix in (".jpg", ".jpeg", ".jpe"):
            assert mine.read_bytes() == theirs.read_bytes(), (name, shape)
        want, got = (cv2.imread(str(p), cv2.IMREAD_UNCHANGED) for p in (theirs, mine))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        try:
            ref = j_readers.ImageReader(theirs).read(0)
        except Exception:  # noqa: BLE001 -- cvtColor refuses the depth
            with pytest.raises(Exception):
                readers.ImageReader(mine).read(0)
            continue
        port = readers.ImageReader(mine).read(0)
        assert port.dtype == ref.dtype, name
        np.testing.assert_array_equal(port, ref, err_msg=name)


@pytest.mark.parametrize("quality", [95, 90, 75, 50, 10, 100])
def test_jpeg_streams_are_byte_identical_to_cv2s(quality):
    """``native.jpeg_encode`` at cv2's quality scaling: grey and colour,
    noise, gradients and flat images, every shape class of the 4:2:0 MCU
    grid (a single pixel, widths and heights of 8n and 16n, 16n + 1, odd
    sizes, one row, one column)."""
    rng = np.random.default_rng(quality)
    for shape in ((1, 1), (2, 3), (8, 8), (16, 16), (17, 33), (37, 53), (15, 17), (9, 31),
                  (24, 40), (31, 16), (16, 31), (1, 50), (50, 1)):
        h, w = shape
        yy, xx = np.mgrid[0:h, 0:w]
        for img in (rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
                    np.stack([(yy * 7 + xx * 3) % 256, (xx * 5) % 256, (yy * 11) % 256],
                             -1).astype(np.uint8),
                    np.full((h, w, 3), (10, 200, 90), np.uint8)):
            for a in (img, img[:, :, 1]):
                want = cv2.imencode(".jpg", a, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
                assert native.jpeg_encode(a, quality=quality) == want, (shape, a.ndim)


def test_saturation_is_cv2s_convert_to_8u():
    """``saturate_u8`` is ``convertTo(CV_8U)``: integers clamped, floats
    rounded half to even, NaN, infinities and magnitudes past 2^31 to 0."""
    vals = np.array([-1.5, -0.5, 0.5, 1.5, 2.5, 127.5, 254.5, 255.5, 300, np.nan, np.inf,
                     -np.inf, 3e9, -3e9, 2.0**31 - 64, 1e10])
    for dt in (np.float32, np.float64, np.float16):
        with np.errstate(over="ignore"):
            v = vals.astype(dt).reshape(1, -1)
        ok, buf = cv2.imencode(".png", v)
        np.testing.assert_array_equal(saturate_u8(v), cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))
    ints = np.array([[-5, 0, 200, 255, 256, 70000]])
    for dt in (np.int8, np.int16, np.int32, np.uint32):
        v = ints.astype(dt)
        ok, buf = cv2.imencode(".png", v)
        np.testing.assert_array_equal(saturate_u8(v), cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("suffix", UNPORTED_SUFFIXES + (".xyz", ""))
def test_unported_suffixes_raise_by_name(tmp_path, suffix):
    """The suffixes cv2 writes and the port does not (ROADMAP A) raise
    ``NotSupportedError`` naming the suffix; a suffix cv2 has no writer
    for raises ``IOError`` (the reference raises too)."""
    img = np.zeros((4, 4), np.uint8)
    path = tmp_path / f"x{suffix}"
    if suffix in UNPORTED_SUFFIXES:
        with pytest.raises(NotSupportedError, match=suffix.replace(".", r"\.")):
            ImageWriter(path).write(img)
    else:
        with pytest.raises(IOError):
            ImageWriter(path).write(img)
        with pytest.raises(Exception):
            JImageWriter(path).write(img)
    assert not path.exists()
