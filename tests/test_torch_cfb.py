"""The port's OLE2 compound-file parser against the JAX package's.

``tmlibrary_tpu_torch.cfb.CompoundFile`` is a copy of
``tmlibrary_tpu.cfb.CompoundFile``; both parse the compound files of
``tests/test_oib.py``'s ``write_cfb`` (version 3 and 4, mini and regular
streams, one storage level and the root) to the same stream paths and
payloads, raise :class:`MetadataError` on the same corruptions, keep the
same hard caps, and give the same outcome on byte flips and truncations.
The OIB cases the reference holds -- the first storage wins a duplicate
plane name, ``OibInfo.txt`` sections per storage, version-4 sectors,
dye names -- read the same planes through both packages' ``OIBReader``
and ``OIFReader``.  Tolerance: exact.
"""

import struct

import numpy as np
import pytest

import test_oib
from tmlibrary_tpu import cfb as j_cfb
from tmlibrary_tpu import errors as j_errors
from tmlibrary_tpu import readers as j_readers
from tmlibrary_tpu_torch import cfb, readers
from tmlibrary_tpu_torch import container_writers as cw
from tmlibrary_tpu_torch.errors import MetadataError

BIG = bytes(np.arange(9000, dtype=np.uint8) % 253)

#: name -> (files, sector size)
LAYOUTS = {
    "mini_and_large": ({"Small.txt": b"hello mini stream",
                        "Dir01/Big.bin": bytes(np.arange(5000, dtype=np.uint8) % 251)}, 512),
    "v4": ({"S/big.bin": BIG, "small.txt": b"mini stream payload"}, 4096),
    "many_streams": ({f"Storage{i // 8:05d}/Stream{i:05d}": bytes([i]) * (37 * i + 1)
                      for i in range(40)}, 512),
    "empty_stream": ({"a.txt": b"", "b/c.bin": b"x" * 4096}, 512),
}


def parse(module, blob):
    cf = module.CompoundFile(blob, "x.oib")
    return {p: cf.read_stream(p) for p in cf.stream_paths}, cf.streams


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_both_parsers_read_the_same_streams(layout):
    files, sect = LAYOUTS[layout]
    blob = test_oib.write_cfb(files, sect=sect)
    assert cw.write_cfb(files, sect=sect) == blob
    got, got_all = parse(cfb, blob)
    want, want_all = parse(j_cfb, blob)
    assert got == want == got_all == want_all == files
    assert cfb.CompoundFile(blob).stream_paths == j_cfb.CompoundFile(blob).stream_paths


def test_the_hard_caps_are_the_reference_caps():
    for name in ("_MAX_SECTORS", "_MAX_DIR_ENTRIES", "_MAGIC", "_ENDOFCHAIN", "_FREESECT",
                 "_NOSTREAM", "_SPECIAL"):
        assert getattr(cfb, name) == getattr(j_cfb, name), name


def _corruptions():
    blob = test_oib.write_cfb({"a.txt": b"x" * 100, "S/b.bin": BIG})
    yield "zeros", b"\x00" * 600
    yield "header_only", blob[:512]
    bad = bytearray(blob)
    struct.pack_into("<I", bad, 48, 10_000)  # directory start into the void
    yield "dir_void", bytes(bad)
    bad = bytearray(blob)
    struct.pack_into("<H", bad, 30, 10)  # sector shift of neither version
    yield "sector_shift", bytes(bad)
    bad = bytearray(blob)
    struct.pack_into("<I", bad, 512 + 4 * 1, 1)  # a FAT entry pointing at itself
    yield "fat_cycle", bytes(bad)
    bad = bytearray(blob)
    struct.pack_into("<I", bad, 68, 0)  # a DIFAT chain starting at the FAT sector
    struct.pack_into("<I", bad, 72, 1)
    yield "difat", bytes(bad)


@pytest.mark.parametrize("name, blob", list(_corruptions()), ids=[n for n, _ in _corruptions()])
def test_corruption_raises_as_in_the_reference(name, blob):
    def outcome(module, error):
        try:
            return parse(module, blob)[0]
        except error as exc:
            return f"MetadataError: {exc}"

    got, want = outcome(cfb, MetadataError), outcome(j_cfb, j_errors.MetadataError)
    assert got == want
    if name in ("zeros", "header_only", "dir_void", "sector_shift"):
        assert isinstance(got, str)


def test_mutated_compound_files_give_the_reference_outcome():
    rng = np.random.default_rng(14)
    blob = test_oib.write_cfb({"Storage00001/a.tif": bytes(range(256)) * 3, "b.txt": BIG})
    for i in range(120):
        mutated = bytearray(blob)
        if i < 100:
            mutated[int(rng.integers(0, len(blob)))] ^= int(rng.integers(1, 256))
        else:
            mutated = mutated[:int(rng.integers(1, len(blob)))]
        outcomes = []
        for module, error in ((cfb, MetadataError), (j_cfb, j_errors.MetadataError)):
            try:
                outcomes.append(parse(module, bytes(mutated))[0])
            except error:
                outcomes.append("MetadataError")
        assert outcomes[0] == outcomes[1], i


def _sections_oib(path):
    rng = np.random.default_rng(9)
    planes = rng.integers(0, 60000, (2, 6, 7), dtype=np.uint16)
    info = "\r\n".join(["[Storage00001]", f"Stream00000={test_oib.plane_name(0, 0, 0)}",
                        "[Storage00002]", f"Stream00000={test_oib.plane_name(1, 0, 0)}",
                        "[General]", "Stream00099=main.oif"])
    path.write_bytes(test_oib.write_cfb({
        "OibInfo.txt": b"\xff\xfe" + info.encode("utf-16-le"),
        "Storage00001/Stream00000": test_oib.tiff_bytes(planes[0]),
        "Storage00002/Stream00000": test_oib.tiff_bytes(planes[1]),
        "Stream00099": b"\xff\xfe" + test_oib.oif_text(7, 6, 2, 1, 1).encode("utf-16-le"),
    }))
    return planes


def _duplicate_oib(path):
    rng = np.random.default_rng(5)
    real = rng.integers(0, 60000, (1, 8, 9), dtype=np.uint16)
    name = test_oib.plane_name(0, 0, 0)
    path.write_bytes(test_oib.write_cfb({
        f"Storage00001/{name}": test_oib.tiff_bytes(real[0]),
        f"Storage00002/{name}": test_oib.tiff_bytes(np.zeros((8, 9), np.uint16))}))
    return real


def _v4_oib(path):
    stack = np.random.default_rng(51).integers(0, 60000, (2, 8, 9), dtype=np.uint16)
    files = {f"Storage00001/{test_oib.plane_name(0, z, 0)}": test_oib.tiff_bytes(stack[z])
             for z in range(2)}
    files["Storage00001/main.oif"] = (b"\xff\xfe"
                                      + test_oib.oif_text(9, 8, 1, 2, 1).encode("utf-16-le"))
    path.write_bytes(test_oib.write_cfb(files, sect=4096))
    return stack


@pytest.mark.parametrize("make", [_sections_oib, _duplicate_oib, _v4_oib],
                         ids=["sections", "duplicate_basename", "v4"])
def test_oib_layouts_read_as_in_the_reference(tmp_path, make):
    path = tmp_path / "a.oib"
    planes = make(path)
    with readers.OIBReader(path) as r, j_readers.OIBReader(path) as jr:
        dims = (r.n_channels, r.n_zplanes, r.n_tpoints, r.height, r.width, r.channel_names)
        assert dims == (jr.n_channels, jr.n_zplanes, jr.n_tpoints, jr.height, jr.width,
                        jr.channel_names)
        for page in range(r.n_channels * r.n_zplanes * r.n_tpoints):
            got = readers._container_plane(r, page)
            np.testing.assert_array_equal(got, j_readers._container_plane(jr, page))
            np.testing.assert_array_equal(got, planes[page])


def test_olympus_dye_names_and_text_helpers(tmp_path):
    stack = np.random.default_rng(23).integers(0, 60000, (2, 3, 2, 16, 20), dtype=np.uint16)
    main = test_oib.write_oif(tmp_path, "dyes_A01", stack)
    extra = "\r\n".join(["[Channel 1 Parameters]", 'DyeName="DAPI"',
                         "[Channel 2 Parameters]", 'CH Name="Alexa 568"'])
    main.write_bytes(main.read_bytes() + ("\r\n" + extra).encode("utf-16-le"))
    with readers.OIFReader(main) as r, j_readers.OIFReader(main) as jr:
        assert r.channel_names == jr.channel_names == ["DAPI", "Alexa 568"]
    text = readers._decode_oif_text(main.read_bytes())
    assert text == j_readers._decode_oif_text(main.read_bytes())
    assert readers._parse_oif_dims(text) == j_readers._parse_oif_dims(text)
    for raw in (b"plain [Axis 0 Parameters Common]", "x".encode("utf-16-le"), b"\xfe\xff\x00"):
        assert readers._decode_oif_text(raw) == j_readers._decode_oif_text(raw)
    for name in ("s_C001Z002T003.tif", "s_C010.tiff", "Stream00001", "a/s_Z003.TIF", "x.tif"):
        assert readers._parse_oif_plane_name(name) == j_readers._parse_oif_plane_name(name)
