"""The port's kernel-library store (``tmlibrary_tpu_torch/aotstore.py``)
against the JAX package's executable store.

On identical meta sidecars ``list_entries`` gives the reference's rows in
the reference's most-recently-used order, and ``prune`` removes the same
entries in the same order (orphans, age, stale fingerprints, the LRU
cap), with both fingerprints pinned to one value.  A dummy library file
is exported and imported back byte for byte, counting the import hit
and the build seconds it saved; a fingerprint that is not this
toolchain's or a corrupt payload refuses loudly.  The kernel build and
the host library build import from the store instead of running their
compiler, and ``cache list|gc`` shows and prunes the store.
"""

import io
import json
import logging
import contextlib

import numpy as np
import pytest

from tmlibrary_tpu import aotstore as j_aotstore
from tmlibrary_tpu_torch import aotstore, cli, native
from tmlibrary_tpu_torch.ops import _cuda

NOW = 1_800_000_000.0
LIVE = "live0000live0000"


def sidecars(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"digest": f"{i:02d}" + "ab" * 19, "program": f"p{i}", "step": "jterator",
             "capacity": None, "strategy": None,
             "fingerprint": LIVE if rng.random() < 0.6 else "old0000000000000",
             "size_bytes": int(rng.integers(1, 100)) * 1000,
             "created_at_unix": NOW - float(rng.uniform(0, 20)) * 86400,
             "last_used_unix": NOW - float(rng.uniform(0, 10)) * 86400}
            for i in range(n)]


def write_store(directory, metas, orphans=True):
    directory.mkdir(parents=True)
    for m in metas:
        (directory / f"{m['digest']}.json").write_text(json.dumps(m))
        (directory / f"{m['digest']}.bin").write_bytes(b"x" * 8)
    if orphans:
        (directory / "deadbeef.bin").write_bytes(b"x")
        (directory / "cafebabe.json").write_text("{not json")


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(aotstore, "backend_fingerprint", lambda info=None: LIVE)
    monkeypatch.setattr(j_aotstore, "backend_fingerprint", lambda info=None: LIVE)
    monkeypatch.setenv("TMX_AOT_STORE", "1")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("gc", [dict(), dict(max_bytes=150_000), dict(max_age_s=7 * 86400),
                                dict(drop_stale_fingerprint=True),
                                dict(max_bytes=1, max_age_s=86400, drop_stale_fingerprint=True)])
def test_list_and_prune_follow_the_reference(tmp_path, pinned, seed, gc):
    metas = sidecars(seed, 12)
    write_store(tmp_path / "ref", metas)
    write_store(tmp_path / "port", metas)

    def rows(mod, d):
        return [{k: v for k, v in m.items() if k != "age_s"} for m in mod.list_entries(str(d))]

    assert rows(aotstore, tmp_path / "port") == rows(j_aotstore, tmp_path / "ref")
    assert aotstore.warm_digests(str(tmp_path / "port"), limit=5) == \
        j_aotstore.warm_digests(str(tmp_path / "ref"), limit=5)
    got = aotstore.prune(str(tmp_path / "port"), **gc)
    want = j_aotstore.prune(str(tmp_path / "ref"), **gc)
    assert got == want
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())


@pytest.fixture
def store(tmp_path, monkeypatch):
    monkeypatch.setenv("TMX_AOT_STORE", "1")
    monkeypatch.setenv("TMX_AOT_STORE_DIR", str(tmp_path / "aot"))
    aotstore.reset_counts()
    aotstore.reset_seconds_saved()
    yield tmp_path / "aot"
    aotstore.reset_counts()
    aotstore.reset_seconds_saved()


def test_export_and_import_a_library(tmp_path, store):
    lib = tmp_path / "libdummy.so"
    lib.write_bytes(bytes(range(256)) * 64)
    digest = aotstore.export_entry(lib, program="cuda_kernels", signature="abc",
                                     compile_s=12.5)
    assert digest == aotstore.entry_digest("cuda_kernels", None, None, "abc")
    assert aotstore.export_entry(lib, program="cuda_kernels", signature="abc") == digest
    meta = json.loads((store / f"{digest}.json").read_text())
    for key in ("digest", "program", "step", "capacity", "strategy", "signature",
                "fingerprint", "fingerprint_info", "size_bytes", "compile_s",
                "created_at_unix", "last_used_unix"):
        assert key in meta, key
    # no compiler and no card count: a host without nvcc imports it
    assert set(meta["fingerprint_info"]) == {"torch", "cuda", "arch"}
    assert set(aotstore.fingerprint_info("host_library")) == {"machine", "system"}
    assert aotstore.import_entry(tmp_path / "miss.so", program="cuda_kernels",
                                   signature="other") is None
    got = aotstore.import_entry(tmp_path / "out" / "lib.so", program="cuda_kernels",
                                  signature="abc")
    assert got["digest"] == digest
    assert (tmp_path / "out" / "lib.so").read_bytes() == lib.read_bytes()
    assert aotstore.counts_snapshot() == {"export": 1.0, "import_hit": 1.0}
    assert aotstore.seconds_saved() == 12.5
    stats = aotstore.store_stats()
    assert (stats["entries"], stats["stale_entries"], stats["dir"]) == (1, 0, str(store))


@pytest.mark.parametrize("damage", ["fingerprint", "payload"])
def test_a_stale_or_corrupt_library_refuses_loudly(tmp_path, store, caplog, damage):
    lib = tmp_path / "libdummy.so"
    lib.write_bytes(b"\x7fELF" * 100)
    digest = aotstore.export_entry(lib, program="host_library", signature="s")
    if damage == "fingerprint":
        meta_path = store / f"{digest}.json"
        meta = json.loads(meta_path.read_text())
        meta_path.write_text(json.dumps({**meta, "fingerprint": "another0toolchn"}))
    else:
        (store / f"{digest}.bin").write_bytes(b"torn")
    with caplog.at_level(logging.WARNING, logger="tmlibrary_tpu_torch.aotstore"):
        assert aotstore.import_entry(tmp_path / "x.so", program="host_library",
                                       signature="s") is None
    assert ("does not match" if damage == "fingerprint" else "corrupt") in caplog.text
    assert not (tmp_path / "x.so").exists()
    assert (store / f"{digest}.bin").exists() == (damage == "fingerprint")
    if damage == "fingerprint":
        assert aotstore.list_entries()[0]["stale"]


def test_the_store_off_is_inert(tmp_path, store, monkeypatch):
    monkeypatch.setenv("TMX_AOT_STORE", "off")
    lib = tmp_path / "lib.so"
    lib.write_bytes(b"x")
    assert not aotstore.enabled()
    assert aotstore.export_entry(lib, program="p", signature="s") is None
    assert aotstore.import_entry(tmp_path / "y.so", program="p", signature="s") is None
    assert not store.exists()


@pytest.mark.parametrize("which", ["kernels", "host"])
def test_the_builds_import_instead_of_compiling(tmp_path, store, monkeypatch, which):
    """No compiler runs here (this machine has no nvcc): the build finds
    the library the store holds for its sources' digest."""
    payload = tmp_path / "built.so"
    payload.write_bytes(b"\x7fELF library")
    if which == "kernels":
        monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "kernels")
        monkeypatch.setattr(_cuda, "_nvcc", lambda: pytest.fail("nvcc ran"))
        signature, program = _cuda._digest(_cuda._sources()), "cuda_kernels"
        builds = _cuda.nvcc_builds
    else:
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
        monkeypatch.setattr(native, "_compiler", lambda: pytest.fail("compiler ran"))
        signature, program = native.source_digest(), "host_library"
    aotstore.export_entry(payload, program=program, signature=signature, compile_s=9.0)
    path = _cuda.build() if which == "kernels" else native.build()
    assert path.read_bytes() == payload.read_bytes()
    assert path.parent == tmp_path / which
    assert aotstore.counts_snapshot()["import_hit"] == 1.0
    assert aotstore.seconds_saved() == 9.0
    if which == "kernels":
        assert _cuda.nvcc_builds == builds and _cuda.last_build_seconds == 0.0


def run_cli(argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def test_cache_list_and_gc(tmp_path, store):
    lib = tmp_path / "lib.so"
    lib.write_bytes(b"y" * 100)
    live = aotstore.export_entry(lib, program="cuda_kernels", signature="live")
    stale = aotstore.export_entry(lib, program="cuda_kernels", signature="stale")
    meta_path = store / f"{stale}.json"
    meta_path.write_text(json.dumps({**json.loads(meta_path.read_text()),
                                     "fingerprint": "planted00000000"}))
    rc, out = run_cli(["cache", "list", "--json"])
    doc = json.loads(out)
    assert rc == 0 and doc["stats"]["entries"] == 2 and doc["stats"]["stale_entries"] == 1
    assert {e["digest"]: e["stale"] for e in doc["entries"]} == {live: False, stale: True}
    rc, out = run_cli(["cache", "list"])
    assert rc == 0 and "STALE" in out and "enabled" in out
    rc, out = run_cli(["cache", "gc", "--keep-stale", "--json"])
    assert json.loads(out)["removed"] == []
    rc, out = run_cli(["cache", "gc", "--dir", str(store), "--json"])
    assert rc == 0 and json.loads(out) == {"removed": [stale], "kept": 1, "total_bytes": 100}
    rc, out = run_cli(["cache", "gc", "--max-bytes", "10"])
    assert rc == 0 and f"- {live}" in out and aotstore.list_entries() == []
