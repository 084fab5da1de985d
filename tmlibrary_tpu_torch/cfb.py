"""OLE2 Compound File Binary (CFB) parser.

Counterpart: ``tmlibrary_tpu/cfb.py``, copied so the port imports
nothing of the JAX package.  The container of Olympus ``.oib`` acquisitions (and several other legacy
microscopy formats: Zeiss ``.zvi``, older ``.ipw``) is Microsoft's
structured-storage format — a FAT filesystem in a file.  The reference
reads these through Bio-Formats' OLE support on the JVM; this is the
equivalent with no JVM: header → DIFAT → FAT →
directory tree → per-stream payloads, with the mini-FAT handling streams
below the 4096-byte cutoff.

Scope: read-only, version 3 (512-byte sectors) and version 4 (4096-byte
sectors), little-endian per spec.  Corruption (cycles, out-of-range
sectors, truncation) raises :class:`~tmlibrary_tpu_torch.errors.MetadataError`
so ingest skips the file instead of crashing.
"""

from __future__ import annotations

import struct

from tmlibrary_tpu_torch.errors import MetadataError

_MAGIC = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"
_ENDOFCHAIN = 0xFFFFFFFE
_FREESECT = 0xFFFFFFFF
_NOSTREAM = 0xFFFFFFFF
_SPECIAL = 0xFFFFFFFA  # any id >= this is a sentinel, not a sector

#: hard caps so a corrupt FAT cannot balloon memory: no real OIB in a
#: microscopy source tree has more than a few thousand plane streams
_MAX_SECTORS = 1 << 22          # 2 GiB of 512-byte sectors
_MAX_DIR_ENTRIES = 1 << 16


class CompoundFile:
    """Parse a CFB container from ``buf`` (bytes, memoryview or mmap).

    Stream payloads are extracted LAZILY: the constructor walks only the
    FAT and the directory tree; ``stream_paths`` lists the slash-joined
    storage paths (root storage omitted, e.g.
    ``"Storage00001/Stream00000"``) and :meth:`read_stream` materializes
    one payload on demand — an open reader over a multi-GB container
    holds the directory tables, not the pixel data (the reader cache
    keeps up to 64 containers open during ingest).  ``streams``
    materializes everything at once for small containers and tests.
    """

    def __init__(self, buf, filename="<buf>"):
        self._buf = memoryview(buf)
        self._name = str(filename)
        if len(self._buf) < 512 or bytes(self._buf[:8]) != _MAGIC:
            raise MetadataError(f"not a compound file: {self._name}")
        (major,) = struct.unpack_from("<H", self._buf, 26)
        (sector_shift,) = struct.unpack_from("<H", self._buf, 30)
        (mini_shift,) = struct.unpack_from("<H", self._buf, 32)
        if (major, sector_shift) not in ((3, 9), (4, 12)) or mini_shift != 6:
            raise MetadataError(
                f"unsupported compound file layout (version {major}, "
                f"sector shift {sector_shift}) in {self._name}"
            )
        self._sec = 1 << sector_shift
        self._mini = 1 << mini_shift
        (self._n_fat,) = struct.unpack_from("<I", self._buf, 44)
        (self._dir_start,) = struct.unpack_from("<I", self._buf, 48)
        (self._cutoff,) = struct.unpack_from("<I", self._buf, 56)
        (self._minifat_start,) = struct.unpack_from("<I", self._buf, 60)
        (difat_start,) = struct.unpack_from("<I", self._buf, 68)
        (n_difat,) = struct.unpack_from("<I", self._buf, 72)
        self._fat = self._parse_fat(difat_start, n_difat)
        self._minifat = self._read_fat_table(self._minifat_start)
        entries = self._parse_directory()
        self._root = entries[0]
        self._ministream: "bytes | None" = None
        self._paths = self._walk(entries)
        self.stream_paths = tuple(self._paths)

    # ------------------------------------------------------------- sectors
    def _sector(self, sid: int) -> memoryview:
        # the header occupies the space of one 512-byte sector; in v4
        # files sector 0 still starts at byte 4096 (one full sector)
        off = self._sec + sid * self._sec
        if sid >= _SPECIAL or off + self._sec > len(self._buf):
            raise MetadataError(f"sector {sid} out of range in {self._name}")
        return self._buf[off:off + self._sec]

    def _parse_fat(self, difat_start: int, n_difat: int) -> list:
        ids = list(struct.unpack_from("<109I", self._buf, 76))
        sid, seen = difat_start, set()
        while sid < _SPECIAL:
            if sid in seen or len(seen) > n_difat + 16:
                raise MetadataError(f"DIFAT cycle in {self._name}")
            seen.add(sid)
            sec = self._sector(sid)
            per = self._sec // 4 - 1
            ids.extend(struct.unpack_from(f"<{per}I", sec, 0))
            (sid,) = struct.unpack_from("<I", sec, self._sec - 4)
        fat: list = []
        per = self._sec // 4
        for fid in ids:
            if fid >= _SPECIAL:
                continue
            fat.extend(struct.unpack_from(f"<{per}I", self._sector(fid), 0))
        return fat

    def _chain(self, start: int, table: list) -> list:
        out: list = []
        seen: set = set()
        sid = start
        while sid < _SPECIAL:
            if sid >= len(table) or len(out) > _MAX_SECTORS:
                raise MetadataError(
                    f"broken sector chain (sid {sid}) in {self._name}"
                )
            if sid in seen:
                raise MetadataError(f"sector chain cycle in {self._name}")
            seen.add(sid)
            out.append(sid)
            sid = table[sid]
        return out

    def _read_chain(self, start: int) -> bytes:
        return b"".join(bytes(self._sector(s)) for s in self._chain(start, self._fat))

    def _read_fat_table(self, start: int) -> list:
        if start >= _SPECIAL:
            return []
        raw = self._read_chain(start)
        return list(struct.unpack_from(f"<{len(raw) // 4}I", raw, 0))

    # ----------------------------------------------------------- directory
    def _parse_directory(self) -> list[dict]:
        raw = self._read_chain(self._dir_start)
        entries = []
        for off in range(0, min(len(raw), _MAX_DIR_ENTRIES * 128), 128):
            chunk = raw[off:off + 128]
            if len(chunk) < 128:
                break
            (name_len,) = struct.unpack_from("<H", chunk, 64)
            obj_type = chunk[66]
            if obj_type == 0 or not 2 <= name_len <= 64:
                entries.append(None)
                continue
            name = chunk[: name_len - 2].decode("utf-16-le", "replace")
            left, right, child = struct.unpack_from("<3I", chunk, 68)
            (start,) = struct.unpack_from("<I", chunk, 116)
            (size,) = struct.unpack_from("<Q", chunk, 120)
            if self._sec == 512:
                size &= 0xFFFFFFFF  # v3: only the low 4 bytes are valid
            entries.append({
                "name": name, "type": obj_type, "left": left,
                "right": right, "child": child, "start": start,
                "size": size,
            })
        if not entries or entries[0] is None or entries[0]["type"] != 5:
            raise MetadataError(f"compound file without root entry: {self._name}")
        return entries

    def _walk(self, entries: list) -> dict[str, dict]:
        paths: dict[str, dict] = {}
        visited: set = set()
        # explicit stack: each storage's children form a binary tree of
        # siblings, and real OIBs hold one stream per plane — a
        # right-leaning chain thousands deep would blow Python's
        # recursion limit
        stack = [(entries[0]["child"], "")]
        while stack:
            eid, prefix = stack.pop()
            if eid == _NOSTREAM or eid >= len(entries):
                continue
            if eid in visited:  # cycles in a corrupt tree
                raise MetadataError(f"directory tree cycle in {self._name}")
            visited.add(eid)
            e = entries[eid]
            if e is None:
                continue
            stack.append((e["left"], prefix))
            stack.append((e["right"], prefix))
            path = prefix + e["name"]
            if e["type"] == 1:  # storage
                stack.append((e["child"], path + "/"))
            elif e["type"] == 2:  # stream
                paths.setdefault(path, e)
        return paths

    def read_stream(self, path: str) -> bytes:
        """Materialize one stream payload."""
        e = self._paths.get(path)
        if e is None:
            raise MetadataError(f"no stream {path!r} in {self._name}")
        size = e["size"]
        if size == 0:
            return b""
        if size < self._cutoff:  # mini stream (64-byte sectors)
            if self._ministream is None:
                root = self._root
                self._ministream = (
                    self._read_chain(root["start"])[: root["size"]]
                    if root["start"] < _SPECIAL and root["size"] else b""
                )
            out = bytearray()
            for sid in self._chain(e["start"], self._minifat):
                lo = sid * self._mini
                if lo + self._mini > len(self._ministream):
                    raise MetadataError(
                        f"mini sector {sid} beyond mini stream in {self._name}"
                    )
                out += self._ministream[lo:lo + self._mini]
            return bytes(out[:size])
        return self._read_chain(e["start"])[:size]

    @property
    def streams(self) -> dict[str, bytes]:
        """All payloads at once (small containers, tests)."""
        return {p: self.read_stream(p) for p in self._paths}
