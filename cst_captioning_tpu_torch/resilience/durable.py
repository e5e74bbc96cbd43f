"""Durable file primitives: fsync'd writes and a checksum manifest (the
JAX package's ``resilience/durable.py``).

``os.replace`` alone orders the rename only against other metadata
operations: after a host crash a freshly renamed checkpoint can read back
truncated unless the files and the directories were fsync'd first. The
manifest (``manifest.json``) records a sha256 and a size per checkpoint
file, so a torn write is detected at load time.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Mapping

MANIFEST_FILE = "manifest.json"


class CorruptCheckpointError(RuntimeError):
    """A checkpoint file failed its manifest checksum or size check."""


def fsync_dir(path: str) -> None:
    """fsync a directory so renames and creates in it survive a crash
    (best effort: some filesystems refuse a directory fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        return
    finally:
        os.close(fd)


def write_bytes_durable(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` and fsync the file."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def write_manifest(dirpath: str, blobs: Mapping[str, bytes]) -> None:
    """Write ``manifest.json`` for the files of ``blobs`` (name -> bytes),
    already written under ``dirpath``; the checksums come from the bytes
    the writer meant to persist, not from a re-read."""
    manifest = {
        "version": 1,
        "files": {
            name: {"sha256": hashlib.sha256(blob).hexdigest(),
                   "size": len(blob)}
            for name, blob in blobs.items()
        },
    }
    write_bytes_durable(os.path.join(dirpath, MANIFEST_FILE),
                        json.dumps(manifest, indent=2).encode())


def verify_manifest(dirpath: str) -> bool:
    """Check every file of ``dirpath``'s manifest. False when there is no
    manifest (an unverifiable legacy checkpoint); raises
    :class:`CorruptCheckpointError` naming each mismatching file."""
    mpath = os.path.join(dirpath, MANIFEST_FILE)
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath, encoding="utf-8") as f:
            files = json.load(f)["files"]
    except (ValueError, KeyError, OSError) as e:
        raise CorruptCheckpointError(
            f"{mpath}: unreadable manifest: {e}") from e
    bad: list[str] = []
    for name, meta in files.items():
        fpath = os.path.join(dirpath, name)
        if not os.path.exists(fpath):
            bad.append(f"{name}: missing")
            continue
        size = os.path.getsize(fpath)
        if size != int(meta["size"]):
            bad.append(f"{name}: size {size} != {meta['size']}")
            continue
        h = hashlib.sha256()
        with open(fpath, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != meta["sha256"]:
            bad.append(f"{name}: sha256 mismatch")
    if bad:
        raise CorruptCheckpointError(
            f"{dirpath}: manifest verification failed: " + "; ".join(bad))
    return True
