"""Zero-copy access to uncompressed .npz spectrogram bundles.

The training corpus ships as one uncompressed ``<dataset>.npz`` per dataset
(reference data layout: beat_this/dataset/dataset.py:88-94, README.md:122).
Loading thousands of mmapped files individually wastes fds and page-cache
churn; instead the whole archive is mapped once and every member array is a
strided view into that single map. Equivalent role to the reference's
MemmappedNpzFile (beat_this/dataset/mmnpz.py), re-implemented around an
eager offset table: at open time we walk the zip central directory, resolve
each member's data offset through its local header, and parse the .npy
header (magic + ast-parsed dict) so lookups afterwards are pure slicing.

The port's copy of beat_this_tpu/data/mmnpz.py, kept so that the port imports nothing of
the JAX package; the tests hold the two to identical results.
"""

from __future__ import annotations

import ast
import struct
from collections.abc import Mapping
from zipfile import ZipFile

import numpy as np

_NPY_MAGIC = b"\x93NUMPY"


class MemmappedNpz(Mapping):
    """Read-only mapping: member name (without ``.npy``) -> ndarray view.

    Only works for uncompressed (ZIP_STORED) archives, which is what the
    preprocessing pipeline writes.
    """

    def __init__(self, path, cache: bool = True, preload: bool = False):
        self.path = path
        self.mmap = np.memmap(path, mode="r")
        self._table: dict[str, tuple[int, np.dtype, tuple, bool]] = {}
        self._cache: dict[str, np.ndarray] | None = (
            {} if (cache or preload) else None
        )
        buf = self.mmap
        with ZipFile(path, "r") as zf:
            for info in zf.infolist():
                if info.compress_type != 0 or not info.filename.endswith(".npy"):
                    continue
                # local header: fixed 30 bytes + name + extra
                lh = info.header_offset
                name_len, extra_len = struct.unpack(
                    "<2H", bytes(buf[lh + 26 : lh + 30])
                )
                data_start = lh + 30 + name_len + extra_len
                offset, dtype, shape, fortran = self._parse_npy_header(data_start)
                self._table[info.filename[:-4]] = (offset, dtype, shape, fortran)
        self.files = list(self._table)
        if preload:
            for name in self.files:
                self[name]

    def _parse_npy_header(self, start: int):
        buf = self.mmap
        if bytes(buf[start : start + 6]) != _NPY_MAGIC:
            raise ValueError("member is not a .npy file")
        major = buf[start + 6]
        if major == 1:
            (hlen,) = struct.unpack("<H", bytes(buf[start + 8 : start + 10]))
            header_start = start + 10
        else:
            (hlen,) = struct.unpack("<I", bytes(buf[start + 8 : start + 12]))
            header_start = start + 12
        header = bytes(buf[header_start : header_start + hlen]).decode("latin1")
        meta = ast.literal_eval(header)
        return (
            header_start + hlen,
            np.dtype(meta["descr"]),
            tuple(meta["shape"]),
            bool(meta["fortran_order"]),
        )

    def _load(self, name: str) -> np.ndarray:
        offset, dtype, shape, fortran = self._table[name]
        count = int(np.prod(shape)) if shape else 1
        flat = self.mmap[offset : offset + count * dtype.itemsize].view(dtype)
        return flat.reshape(shape, order="F" if fortran else "C")

    def __getitem__(self, name: str) -> np.ndarray:
        if self._cache is not None:
            arr = self._cache.get(name)
            if arr is None:
                arr = self._cache[name] = self._load(name)
            return arr
        return self._load(name)

    def __contains__(self, name) -> bool:
        return name in self._table

    def __iter__(self):
        return iter(self._table)

    def __len__(self):
        return len(self._table)

    def close(self):
        if hasattr(self, "mmap"):
            del self.mmap
        self._cache = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_npz(path, arrays: dict) -> None:
    """Write an uncompressed .npz bundle (counterpart of the reference's
    `create_npz`, launch_scripts/preprocess_audio.py:383-393)."""
    import io
    from zipfile import ZIP_STORED

    with ZipFile(path, "w", ZIP_STORED) as zf:
        for name, arr in arrays.items():
            bio = io.BytesIO()
            np.save(bio, np.asarray(arr))
            zf.writestr(f"{name}.npy", bio.getvalue())
