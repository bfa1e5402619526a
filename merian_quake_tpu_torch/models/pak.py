"""Quake PAK archive reader.

Equivalent of quakespasm's COM_LoadFile / pack file support (the
reference reaches assets through quakespasm's -basedir search,
README.md:38-42). Format: "PACK" magic, directory offset/size, 64-byte
entries (56-byte zero-padded name + u32 offset + u32 size).

Copy of merian_quake_tpu/models/pak.py (plain Python).
"""
from __future__ import annotations

import os
import struct


class PakFile:
    def __init__(self, path: str):
        self.path = path
        self._entries: dict[str, tuple[int, int]] = {}
        with open(path, "rb") as f:
            magic, dir_ofs, dir_len = struct.unpack("<4sii", f.read(12))
            if magic != b"PACK":
                raise ValueError(f"{path}: not a PAK file")
            f.seek(dir_ofs)
            for _ in range(dir_len // 64):
                raw = f.read(64)
                name = raw[:56].split(b"\0", 1)[0].decode("latin-1").lower()
                ofs, size = struct.unpack("<ii", raw[56:])
                self._entries[name] = (ofs, size)

    def names(self):
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._entries

    def read(self, name: str) -> bytes:
        ofs, size = self._entries[name.lower()]
        with open(self.path, "rb") as f:
            f.seek(ofs)
            return f.read(size)


def write_pak(path: str, files: dict[str, bytes]):
    """Create a PAK archive (used by tests and tooling)."""
    entries = []
    with open(path, "wb") as f:
        f.write(b"\0" * 12)
        for name, data in files.items():
            entries.append((name, f.tell(), len(data)))
            f.write(data)
        dir_ofs = f.tell()
        for name, ofs, size in entries:
            raw = name.encode("latin-1")[:55].ljust(56, b"\0")
            f.write(raw + struct.pack("<ii", ofs, size))
        dir_len = f.tell() - dir_ofs
        f.seek(0)
        f.write(struct.pack("<4sii", b"PACK", dir_ofs, dir_len))


class FileSearchPath:
    """basedir-style search: loose files win over PAK contents
    (quakespasm COM_FindFile order)."""

    def __init__(self, basedirs: list[str]):
        self.basedirs = basedirs
        self.paks: list[PakFile] = []
        for d in basedirs:
            if not os.path.isdir(d):
                continue
            for fn in sorted(os.listdir(d)):
                if fn.lower().startswith("pak") and fn.lower().endswith(".pak"):
                    self.paks.append(PakFile(os.path.join(d, fn)))

    def read(self, name: str) -> bytes:
        for d in self.basedirs:
            p = os.path.join(d, name)
            if os.path.isfile(p):
                with open(p, "rb") as f:
                    return f.read()
        for pak in reversed(self.paks):  # later paks override
            if name in pak:
                return pak.read(name)
        raise FileNotFoundError(name)
