"""Atomic file persistence — write a same-directory temp file, then
`os.replace` it into place — plus the warehouse npz container (a copy of
the reference's `core/persist.py`, numpy only).

Every on-disk artifact this package produces (session saves, report
JSON/HTML) may be read concurrently: a profiler re-saving a session while
CI artifact collection or a browser reload reads it.  A plain
`open(path, "w")` exposes truncated intermediate states to those
readers; renaming a fully-written sibling is atomic on POSIX, so a
reader sees either the old artifact or the new one — never a torn file.

`write_npz` / `open_npz_mmap` are the fleet-scale replacements for
`np.savez_compressed` / `np.load` on session artifacts:

  * `write_npz` emits a *deterministic* `np.load`-compatible zip —
    member timestamps pinned to the DOS epoch, no extra fields, fixed
    member order — so saving the same session twice yields the same
    bytes (`np.savez_compressed` stamps wall-clock member times, which
    made byte-level artifact comparison flaky).  Members DEFLATE in a
    thread pool: `zlib` releases the GIL, so per-trace compression
    overlaps across cores while a single writer assembles the archive.
  * `open_npz_mmap` opens an *uncompressed* `write_npz` archive
    zero-copy: each member's array data is `np.memmap`'d read-only at
    its offset inside the zip, so a 10M-site session "loads" without
    materializing a byte of column data until it is touched.
"""
from __future__ import annotations

import contextlib
import io
import os
import struct
import tempfile
import zlib
from typing import Dict, Iterator, Mapping, Optional

import numpy as np


def _fsync_dir(dirpath: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss.

    `os.replace` makes the rename atomic for concurrent *readers*, but
    the new directory entry itself lives in the page cache until the
    directory inode is flushed — a crash between the rename and that
    flush can resurrect the old file (or neither).  Checkpoint/resume
    correctness needs the rename to be durable, not just atomic.  Filesystems that cannot fsync a directory fd (or
    platforms without O_DIRECTORY) are tolerated silently.
    """
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0)
    try:
        fd = os.open(dirpath, flags)
    except OSError:
        return
    try:
        with contextlib.suppress(OSError):
            os.fsync(fd)
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_open(path: str, mode: str = "w"):
    """`open(path, mode)` with atomic-replace semantics.

    Yields a file object over a temp file created in `path`'s directory
    (same filesystem, so the final rename cannot cross a mount).  On
    clean exit the temp file is flushed, fsync'd, renamed over `path`,
    and the parent directory is fsync'd (the rename is durable, not
    just atomic); on any error it is removed and `path` is left
    untouched.  `mode` must be a write mode ("w" or "wb").
    """
    if mode not in ("w", "wb"):
        raise ValueError(f"atomic_open requires a write mode, got {mode!r}")
    target = os.path.abspath(path)
    parent = os.path.dirname(target)
    fd, tmp = tempfile.mkstemp(dir=parent,
                               prefix=os.path.basename(target) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
        _fsync_dir(parent)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


# --------------------------------------------------------------------------
# deterministic npz container (parallel compress, mmap-able when stored)
# --------------------------------------------------------------------------

# pinned member timestamp: the DOS epoch (1980-01-01 00:00:00).  Zip has
# no "no timestamp" encoding, so determinism means pinning it.
_DOS_DATE = (1 << 5) | 1
_DOS_TIME = 0
_ZIP64_LIMIT = 0xFFFFFFFF - 1


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    # np.ascontiguousarray would promote 0-d members (the JSON side-car
    # strings) to 1-d; write_array copies non-contiguous input itself.
    np.lib.format.write_array(buf, np.asarray(arr), allow_pickle=False)
    return buf.getvalue()


def _prep_member(name: str, arr: np.ndarray, compress: bool, level: int):
    """Serialize + (optionally) deflate one member: CPU-bound, GIL-free
    in the zlib portion, so members prep concurrently in threads."""
    raw = _npy_bytes(arr)
    crc = zlib.crc32(raw) & 0xFFFFFFFF
    if compress:
        co = zlib.compressobj(level, zlib.DEFLATED, -15)   # raw DEFLATE
        data = co.compress(raw) + co.flush()
        method = 8
    else:
        data, method = raw, 0
    return name, method, crc, len(raw), data


def write_npz(fp, arrays: Mapping[str, np.ndarray], *, compress: bool = True,
              level: int = 6, workers: Optional[int] = None) -> None:
    """Write `arrays` to `fp` as a deterministic `np.load`-compatible npz.

    Unlike `np.savez_compressed`, the output is a pure function of the
    array contents: member order follows the dict, timestamps are pinned
    to the DOS epoch, and no platform-dependent extra fields are
    emitted — saving the same session twice is byte-identical (pinned by
    tests/test_warehouse.py).  With `compress=True` members DEFLATE in a
    thread pool (`workers`, default one per core capped at 8) while this
    single writer assembles the archive in order; `compress=False`
    stores members raw, the layout `open_npz_mmap` maps zero-copy.

    Archives stay in classic zip territory (no zip64): a member or the
    archive crossing 4 GiB raises rather than silently corrupting.
    """
    items = [(f"{key}.npy", arr) for key, arr in arrays.items()]
    if len(items) >= 0xFFFF:
        raise ValueError(f"too many npz members for zip ({len(items)})")
    if workers is None:
        workers = min(os.cpu_count() or 1, 8)
    if compress and workers > 1 and len(items) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as ex:
            prepped = list(ex.map(
                lambda it: _prep_member(it[0], it[1], compress, level),
                items))
    else:
        prepped = [_prep_member(n, a, compress, level) for n, a in items]

    offset = 0
    central = []
    for name, method, crc, usize, data in prepped:
        fn = name.encode("ascii")
        csize = len(data)
        if max(csize, usize, offset) > _ZIP64_LIMIT:
            raise ValueError(
                f"npz member {name!r} needs zip64 (>4GiB), unsupported")
        fp.write(struct.pack("<4s5H3I2H", b"PK\x03\x04", 20, 0, method,
                             _DOS_TIME, _DOS_DATE, crc, csize, usize,
                             len(fn), 0))
        fp.write(fn)
        fp.write(data)
        central.append((fn, method, crc, csize, usize, offset))
        offset += 30 + len(fn) + csize
    cd_start = offset
    for fn, method, crc, csize, usize, off in central:
        fp.write(struct.pack("<4s6H3I5H2I", b"PK\x01\x02", 20, 20, 0,
                             method, _DOS_TIME, _DOS_DATE, crc, csize,
                             usize, len(fn), 0, 0, 0, 0, 0, off))
        fp.write(fn)
        offset += 46 + len(fn)
    fp.write(struct.pack("<4s4H2IH", b"PK\x05\x06", 0, 0, len(central),
                         len(central), offset - cd_start, cd_start, 0))


def _read_npy_header(f):
    """(shape, fortran_order, dtype, data_offset) of the npy at f's pos."""
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        raise ValueError(f"unsupported npy format version {version}")
    return shape, fortran, dtype, f.tell()


class MmapNpz(Mapping):
    """Read-only zero-copy view of an uncompressed npz archive.

    Member arrays are `np.memmap`'d (mode="r") at their data offset
    inside the zip on first access and cached; nothing is read up front
    beyond the member directory.  The maps are not writeable — mutating
    consumers (`TraceStore.append`, `Categorical.extend`) already seed
    fresh buffers when a column does not alias their own capacity
    buffer, so copy-on-write falls out of the existing append contract.
    Non-numeric members (the 0-d JSON side-car strings) are decoded
    eagerly — they are small by design.
    """

    def __init__(self, path: str):
        import zipfile
        self.path = os.path.abspath(path)
        self._members: Dict[str, int] = {}
        self._cache: Dict[str, np.ndarray] = {}
        with zipfile.ZipFile(self.path) as zf:
            for zi in zf.infolist():
                if zi.compress_type != zipfile.ZIP_STORED:
                    raise ValueError(
                        f"{path}: member {zi.filename!r} is compressed — "
                        f"mmap load needs an uncompressed save "
                        f"(session save with compress=False / "
                        f"`session ingest --no-compress`)")
                key = zi.filename[:-4] if zi.filename.endswith(".npy") \
                    else zi.filename
                self._members[key] = zi.header_offset

    def __getitem__(self, key: str) -> np.ndarray:
        arr = self._cache.get(key)
        if arr is not None:
            return arr
        header_offset = self._members[key]     # raises KeyError
        with open(self.path, "rb") as f:
            f.seek(header_offset)
            hdr = f.read(30)
            if len(hdr) != 30 or hdr[:4] != b"PK\x03\x04":
                raise ValueError(f"{self.path}: bad zip member at "
                                 f"{header_offset} ({key!r})")
            fnlen, extralen = struct.unpack("<HH", hdr[26:30])
            f.seek(header_offset + 30 + fnlen + extralen)
            shape, fortran, dtype, data_off = _read_npy_header(f)
            n_items = 1
            for d in shape:
                n_items *= d
            if dtype.hasobject or dtype.kind in "USV" or n_items == 0:
                # side-car strings / empty columns: tiny, read eagerly
                f.seek(header_offset + 30 + fnlen + extralen)
                arr = np.lib.format.read_array(f, allow_pickle=False)
            else:
                arr = np.memmap(self.path, dtype=dtype, mode="r",
                                offset=data_off, shape=shape,
                                order="F" if fortran else "C")
        self._cache[key] = arr
        return arr

    def __contains__(self, key) -> bool:
        return key in self._members

    def __iter__(self) -> Iterator[str]:
        return iter(self._members)

    def __len__(self) -> int:
        return len(self._members)


def open_npz_mmap(path: str) -> MmapNpz:
    """Open an uncompressed `write_npz` archive for zero-copy reads."""
    return MmapNpz(path)
