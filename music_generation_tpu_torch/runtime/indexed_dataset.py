"""Indexed binary dataset: one `.data` blob + `.idx` offset table.

Twin of music_generation_tpu/runtime/indexed_dataset.py, and the same file
format byte for byte: a corpus packed by either package reads in the other.
A rebuild of the reference's pickled IndexedDataset
(VISinger/utils/indexed_datasets.py:7-54). Same two-file shape, but:

- records are dicts of numpy arrays serialized with a fixed little-endian
  header (no pickle — loading a dataset can't execute code),
- the index is a flat uint64 table (``MGIDX1`` magic + count + offsets),
- reads go through the native C++ reader (mmap, OpenMP batch gather) when
  `runtime/native/indexed_dataset.cc` built (runtime/native_loader.py); a
  pure-Python mmap fallback produces byte-identical files and results.

Typical use: pack a preprocessed-npy training directory once
(`train.dataset.pack_dataset`), then train with `--packed`, which replaces
thousands of tiny per-field .npy opens per epoch with offset reads from one
mapped file.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from .native_loader import _load, native_calls

# dtype codes in the record header (index == code)
_DTYPES = ("<f4", "<i4", "<i8", "<f8", "<i2", "|u1", "<f2", "<u4", "<u8",
           "|b1")
_DTYPE_CODE = {np.dtype(s): i for i, s in enumerate(_DTYPES)}


def encode_item(item: Dict[str, np.ndarray]) -> bytes:
    """Serialize a dict of numpy arrays (sorted by key) to record bytes."""
    parts = [struct.pack("<I", len(item))]
    for key in sorted(item):
        arr = np.ascontiguousarray(item[key])
        if arr.dtype not in _DTYPE_CODE:
            raise TypeError(f"unsupported dtype {arr.dtype} for field {key!r}")
        kb = key.encode("utf-8")
        parts.append(struct.pack("<H", len(kb)))
        parts.append(kb)
        parts.append(struct.pack("<BB", _DTYPE_CODE[arr.dtype], arr.ndim))
        parts.append(struct.pack(f"<{arr.ndim}I", *arr.shape))
        parts.append(arr.tobytes())
    return b"".join(parts)


def decode_item(buf) -> Dict[str, np.ndarray]:
    """Inverse of encode_item. Always copies out of ``buf`` (safe to use
    after the underlying mmap is closed)."""
    view = memoryview(buf)
    (n_fields,) = struct.unpack_from("<I", view, 0)
    off = 4
    out: Dict[str, np.ndarray] = {}
    for _ in range(n_fields):
        (klen,) = struct.unpack_from("<H", view, off)
        off += 2
        key = bytes(view[off:off + klen]).decode("utf-8")
        off += klen
        code, ndim = struct.unpack_from("<BB", view, off)
        off += 2
        shape = struct.unpack_from(f"<{ndim}I", view, off)
        off += 4 * ndim
        dt = np.dtype(_DTYPES[code])
        nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        out[key] = np.frombuffer(view, dtype=dt, count=nbytes // dt.itemsize,
                                 offset=off).reshape(shape).copy()
        off += nbytes
    return out


class IndexedDatasetBuilder:
    """Append records, then finalize() writes the offset index.

    Parity surface: IndexedDatasetBuilder.add_item/finalize
    (indexed_datasets.py:41-54), minus pickle."""

    def __init__(self, path: str):
        self.path = path
        self._lib = _load()
        if self._lib is not None:
            self._handle = self._lib.idx_builder_open(path.encode())
            if not self._handle:
                raise OSError(f"cannot open {path}.data for writing")
        else:
            self._file = open(f"{path}.data", "wb")
            self._offsets = [0]

    def add_item(self, item: Dict[str, np.ndarray]) -> int:
        blob = encode_item(item)
        if self._lib is not None:
            idx = self._lib.idx_builder_add(self._handle, blob, len(blob))
            if idx < 0:
                raise OSError("short write to .data")
            return int(idx)
        self._file.write(blob)
        self._offsets.append(self._offsets[-1] + len(blob))
        return len(self._offsets) - 2

    def finalize(self) -> None:
        if self._lib is not None:
            if self._lib.idx_builder_finalize(self._handle,
                                              self.path.encode()) != 0:
                raise OSError(f"cannot write {self.path}.idx")
            self._handle = None
            return
        self._file.close()
        with open(f"{self.path}.idx", "wb") as f:
            f.write(b"MGIDX1\x00\x00")
            f.write(struct.pack("<Q", len(self._offsets) - 1))
            f.write(np.asarray(self._offsets, np.uint64).tobytes())


class IndexedDataset:
    """Random-access reader. `ds[i]` -> dict of arrays; `read_batch(ids)`
    gathers many records with one parallel native copy. ``native`` says
    which reader this one is."""

    def __init__(self, path: str):
        self.path = path
        self._lib = _load()
        if self._lib is not None:
            self._handle = self._lib.idx_reader_open(path.encode())
            if not self._handle:
                raise OSError(f"cannot open indexed dataset {path}")
            self._len = int(self._lib.idx_reader_len(self._handle))
        else:
            with open(f"{path}.idx", "rb") as f:
                if f.read(8) != b"MGIDX1\x00\x00":
                    raise OSError(f"bad index magic in {path}.idx")
                (n,) = struct.unpack("<Q", f.read(8))
                self._offsets = np.frombuffer(f.read(8 * (n + 1)), np.uint64)
            self._len = int(n)
            self._file = open(f"{path}.data", "rb")
            self._mmap: Optional[mmap.mmap] = None
            if os.path.getsize(f"{path}.data") > 0:
                self._mmap = mmap.mmap(self._file.fileno(), 0,
                                       access=mmap.ACCESS_READ)

    def __len__(self) -> int:
        return self._len

    @property
    def native(self) -> bool:
        return self._lib is not None

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if not 0 <= i < self._len:
            raise IndexError("index out of range")
        return decode_item(self._record_bytes(i))

    def _record_bytes(self, i: int) -> bytes:
        if self._lib is not None:
            n = int(self._lib.idx_reader_size(self._handle, i))
            ptr = self._lib.idx_reader_ptr(self._handle, i)
            return ctypes.string_at(ptr, n)
        lo, hi = int(self._offsets[i]), int(self._offsets[i + 1])
        return self._mmap[lo:hi] if self._mmap is not None else b""

    def read_batch(self, ids: Sequence[int]) -> List[Dict[str, np.ndarray]]:
        for i in ids:
            if not 0 <= i < self._len:
                raise IndexError("index out of range")
        if self._lib is None:
            return [self[i] for i in ids]
        sizes = [int(self._lib.idx_reader_size(self._handle, i)) for i in ids]
        dst_off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        buf = np.empty(int(dst_off[-1]), np.uint8)
        ids_arr = np.asarray(ids, np.int64)
        self._lib.idx_reader_gather(
            self._handle,
            ids_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(ids),
            buf.ctypes.data_as(ctypes.c_char_p),
            dst_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        native_calls["read_batch"] += 1
        return [decode_item(buf[dst_off[k]:dst_off[k + 1]])
                for k in range(len(ids))]

    def close(self) -> None:
        if self._lib is not None:
            if self._handle:
                self._lib.idx_reader_close(self._handle)
                self._handle = None
        else:
            if self._mmap is not None:
                self._mmap.close()
                self._mmap = None
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
