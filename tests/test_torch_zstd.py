"""The port's Zstandard codec (``csrc/host/zstd.cpp`` through
:mod:`tmlibrary_tpu_torch.native`) against ``zstandard`` (libzstd), and its
CZI zstd0/zstd1 subblock decode against the JAX package's
``_czi_zstd_plane``.

Frames made by ``zstandard`` at levels 1, 3, 9, 19 and 22, with and
without the content checksum, over 0 B to 2 MiB of blobby, noise and
constant data, decode to the same bytes; frames back to back, skippable
frames, frames without a content size, dictionary frames and corrupt
checksums behave as libzstd does; the port's encoder's frames decode in
``zstandard``.  On byte flips and truncations of frames the port gives
the same bytes as libzstd or raises where libzstd raises; on the
Huffman literals of 4-stream blocks it is stricter than libzstd's fast
decoder (ROADMAP C).  Tolerance: exact.
"""

import numpy as np
import pytest
import zstandard

import test_czi
from tmlibrary_tpu import errors as j_errors
from tmlibrary_tpu.readers import _czi_zstd_plane as j_plane
from tmlibrary_tpu_torch import native
from tmlibrary_tpu_torch.errors import MetadataError
from tmlibrary_tpu_torch.readers import _czi_zstd_plane

SIZES = (0, 1, 7, 144, 1000, 5000, 70_000, 300_000, 2 * 1024 * 1024)


def data(kind: str, n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "constant":
        return bytes([7]) * n
    walk = np.cumsum(rng.normal(0, 3, n)).astype(np.int64) % 200  # blobby: smooth runs
    return walk.astype(np.uint8).tobytes()


def ref_decode(frame: bytes, expect: int) -> "bytes | None":
    """What the JAX package's path gets from libzstd, or None where it raises."""
    try:
        declared = zstandard.frame_content_size(frame)
        if declared not in (-1, expect):
            return None
        return zstandard.ZstdDecompressor().decompress(frame, max_output_size=expect)
    except zstandard.ZstdError:
        return None


def port_decode(frame: bytes, expect: int) -> "bytes | None":
    try:
        declared = native.zstd_frame_content_size(frame)
        if declared not in (-1, expect):
            return None
        return native.zstd_decompress(frame, expect, all_frames=False)
    except MetadataError:
        return None


@pytest.mark.parametrize("level", [1, 3, 9, 19, 22])
@pytest.mark.parametrize("kind", ["blobby", "noise", "constant"])
def test_frames_of_every_level_decode_as_libzstd(kind, level):
    for n in SIZES:
        if level >= 19 and n > 300_000:
            continue  # the slow levels on the 2 MiB input take seconds each
        raw = data(kind, n, seed=n)
        for checksum in (False, True):
            frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(raw)
            assert native.zstd_frame_content_size(frame) == zstandard.frame_content_size(frame)
            assert native.zstd_decompress(frame, n) == raw, (n, checksum)


def test_frames_back_to_back_skippable_and_unsized():
    a, b = data("blobby", 5000, 1), data("noise", 3000, 2)
    fa, fb = (zstandard.ZstdCompressor(level=3).compress(x) for x in (a, b))
    skip = b"\x50\x2a\x4d\x18" + (5).to_bytes(4, "little") + b"hello"
    # every frame, skippable ones skipped (the RFC's stream) ...
    assert native.zstd_decompress(fa + skip + fb, 8000) == a + b
    assert native.zstd_decompress(skip + fa, 5000) == a
    # ... or the first frame and what follows ignored, as zstandard does
    assert native.zstd_decompress(fa + fb, 8000, all_frames=False) == \
        zstandard.ZstdDecompressor().decompress(fa + fb) == a
    assert native.zstd_decompress(fa + b"junk", 5000, all_frames=False) == a
    assert native.zstd_frame_content_size(skip) == zstandard.frame_content_size(skip) == 0
    # no content size: capped at the caller's size, as max_output_size caps it
    unsized = zstandard.ZstdCompressor(write_content_size=False).compress(a)
    assert native.zstd_frame_content_size(unsized) == -1
    assert native.zstd_decompress(unsized, 5000) == a
    with pytest.raises(MetadataError):
        native.zstd_decompress(unsized, 4999)
    with pytest.raises(zstandard.ZstdError):
        zstandard.ZstdDecompressor().decompress(unsized, max_output_size=4999)
    # the empty frame and headers too short to parse
    empty = zstandard.ZstdCompressor().compress(b"")
    assert native.zstd_decompress(empty, 0) == b"" and native.zstd_frame_content_size(empty) == 0
    for bad in (b"", b"\x28\xb5\x2f", b"not zstd at all"):
        with pytest.raises(zstandard.ZstdError):
            zstandard.frame_content_size(bad)
        with pytest.raises(MetadataError):
            native.zstd_frame_content_size(bad)


def test_a_bad_checksum_and_a_dictionary_frame_fail_in_both():
    raw = data("blobby", 4000, 3)
    frame = bytearray(zstandard.ZstdCompressor(write_checksum=True).compress(raw))
    frame[-1] ^= 0x40
    assert ref_decode(bytes(frame), len(raw)) is None
    with pytest.raises(MetadataError, match="checksum"):
        native.zstd_decompress(bytes(frame), len(raw))
    samples = [data("blobby", 500, s) for s in range(40)]
    zdict = zstandard.train_dictionary(1024, samples)
    with_dict = zstandard.ZstdCompressor(dict_data=zdict).compress(samples[0])
    assert ref_decode(with_dict, 500) is None  # no dictionary: libzstd refuses it
    with pytest.raises(MetadataError, match="Dictionary"):
        native.zstd_decompress(with_dict, 500)


def test_the_bomb_is_refused_before_allocation():
    """tests/test_czi.py:299-311: a small frame declaring 50 MB."""
    bomb = zstandard.ZstdCompressor().compress(b"\x00" * 50_000_000)
    assert len(bomb) < 10_000
    with pytest.raises(MetadataError, match="declares"):
        _czi_zstd_plane(bomb, 8, 8, False, "bomb.czi")
    with pytest.raises(j_errors.MetadataError, match="declares"):
        j_plane(bomb, 8, 8, False, "bomb.czi")
    with pytest.raises(MetadataError, match="too small"):
        native.zstd_decompress(bomb, 128)  # checked against the cap before decoding


def hilo(plane: np.ndarray) -> bytes:
    a = plane.astype("<u2").ravel()
    return (a & 0xFF).astype(np.uint8).tobytes() + (a >> 8).astype(np.uint8).tobytes()


def plane_cases():
    rng = np.random.default_rng(11)
    p16 = rng.integers(0, 4000, (12, 10)).astype(np.uint16)
    p8 = rng.integers(0, 255, (12, 10)).astype(np.uint8)
    z = zstandard.ZstdCompressor().compress
    return {
        "zstd0_u16": (z(p16.tobytes()), 12, 10, False, 2),
        "zstd0_u8": (z(p8.tobytes()), 12, 10, False, 1),
        "zstd1_hilo": (bytes([3, 1, 1]) + z(hilo(p16)), 12, 10, True, 2),
        "zstd1_plain": (bytes([3, 1, 0]) + z(p16.tobytes()), 12, 10, True, 2),
        "zstd1_hilo_on_gray8": (bytes([3, 1, 1]) + z(p8.tobytes()), 12, 10, True, 1),
        "zstd1_long_header": (bytes([5, 2, 9, 1, 1]) + z(hilo(p16)), 12, 10, True, 2),
        "zstd1_bad_header": (bytes([40]) + z(p16.tobytes()), 12, 10, True, 2),
        "zstd1_empty": (b"", 12, 10, True, 2),
        "wrong_size": (z(p16.tobytes()[:-2]), 12, 10, False, 2),
        "unsized_short": (zstandard.ZstdCompressor(write_content_size=False).compress(
            p16.tobytes()[:100]), 12, 10, False, 2),
        "not_zstd": (b"\x00" * 40, 12, 10, False, 2),
    }


def outcome(fn, args):
    try:
        out = fn(*args)
        return out.dtype.str, out.tobytes()
    except (MetadataError, j_errors.MetadataError) as exc:
        return type(exc).__name__, " ".join(str(exc).split()[:3])


@pytest.mark.parametrize("case", sorted(plane_cases()))
def test_czi_zstd_plane_equals_the_reference(case):
    raw, h, w, zstd1, itemsize = plane_cases()[case]
    args = (raw, h, w, zstd1, "x.czi", itemsize)
    assert outcome(_czi_zstd_plane, args) == outcome(j_plane, args)


def mutations(blob: bytes, rng, flips: int = 60, cuts: int = 20):
    """tests/test_reader_fuzz.py's: byte flips, then truncations."""
    for _ in range(flips):
        pos = int(rng.integers(0, len(blob)))
        m = bytearray(blob)
        m[pos] ^= int(rng.integers(1, 256))
        yield bytes(m)
    for _ in range(cuts):
        yield blob[:int(rng.integers(1, len(blob)))]


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_mutated_czi_fixture_frames_decode_as_libzstd(seed):
    """The subblocks of tests/test_reader_fuzz.py:118-126 (zstd1 hi-lo of
    8x9 uint16 planes), mutated: the same bytes or an error in both."""
    rng = np.random.default_rng(seed)
    plane = rng.integers(0, 4000, (8, 9), dtype=np.uint16)
    frame = zstandard.ZstdCompressor().compress(hilo(plane))
    for i, m in enumerate(mutations(frame, rng, 200, 40)):
        assert port_decode(m, 144) == ref_decode(m, 144), i


@pytest.mark.parametrize("n", [1000, 5000, 40_000])
def test_mutated_large_frames_never_decode_where_libzstd_refuses(n):
    """Bigger frames (4-stream Huffman literals): where libzstd raises the
    port raises, and where both decode the bytes are equal.  The port
    also refuses streams libzstd's fast Huffman decoder lets through
    (their bit streams do not end where the block says)."""
    rng = np.random.default_rng(n)
    a = rng.integers(0, 4000, n // 2).astype("<u2")
    frame = zstandard.ZstdCompressor(level=3).compress(hilo(a.reshape(1, -1)))
    stricter = 0
    for i, m in enumerate(mutations(frame, rng, 150, 30)):
        want, got = ref_decode(m, n), port_decode(m, n)
        if got is None and want is not None:
            stricter += 1
            continue
        assert got == want, i
    assert stricter < 120


@pytest.mark.parametrize("kind", ["blobby", "noise", "constant", "u16", "hilo"])
def test_the_port_encoder_frames_decode_in_zstandard(kind):
    rng = np.random.default_rng(5)
    for n in (0, 1, 63, 64, 1000, 131_072, 131_073, 600_000):
        if kind == "u16":
            raw = rng.integers(0, 4000, n // 2 + 1).astype("<u2").tobytes()[:n]
        elif kind == "hilo":
            raw = hilo(rng.integers(0, 4000, (1, n // 2)).astype(np.uint16))
        else:
            raw = data(kind, n, n)
        frame = native.zstd_compress(raw)
        assert zstandard.frame_content_size(frame) == len(raw)
        assert zstandard.ZstdDecompressor().decompress(frame) == raw, n
        assert native.zstd_decompress(frame, len(raw)) == raw
    if kind in ("blobby", "constant", "hilo"):  # it does compress
        assert len(native.zstd_compress(raw)) < len(raw) * {"blobby": 0.9, "hilo": 0.85,
                                                           "constant": 0.01}[kind]


def test_czi_zstd_subblocks_of_both_writers_read_alike(tmp_path):
    """CZIs with zstd0 and zstd1 (hi-lo) subblocks written by the JAX
    package's test writer (``zstandard``) and by the port's
    (``container_writers``, the port's encoder) read the same planes in
    both packages."""
    from tmlibrary_tpu import readers as j_readers
    from tmlibrary_tpu_torch import container_writers as cw
    from tmlibrary_tpu_torch import readers

    planes = np.random.default_rng(7).integers(0, 4000, (2, 2, 24, 40)).astype(np.uint16)
    for compression, hl in ((5, False), (6, True), (6, False)):
        for name, write in (("ref", test_czi.write_czi), ("port", cw.write_czi)):
            path = tmp_path / f"{name}_{compression}_{hl}.czi"
            write(path, planes, compression=compression, hilo=hl)
            for pkg in (readers, j_readers):
                with pkg.CZIReader(path) as r:
                    for s in range(2):
                        for c in range(2):
                            np.testing.assert_array_equal(r.read_plane(s, c), planes[s, c])
