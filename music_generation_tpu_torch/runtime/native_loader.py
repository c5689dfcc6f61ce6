"""ctypes loader for the port's native C++ host library.

Twin of music_generation_tpu/runtime/native_loader.py over the port's own
copies of the sources (runtime/native/*.cc: the indexed-dataset reader and
writer, YIN F0, the MAS host oracle). They are host code, not GPU kernels.
On first use ``g++`` compiles them into one shared library under
``build/music_generation_tpu_torch/`` (beside ops/build.py's CUDA
libraries), named by a hash of the sources, the flags and the host CPU, so
that an edited source or another machine's ``-march=native`` build is never
loaded. The flags are the JAX package's Makefile's; a toolchain without
OpenMP's runtime (no ``libgomp``) builds the same sources without
``-fopenmp``, so the loops run on one thread with the same results
(``openmp`` says which). When the toolchain is missing,
``native_available()`` is False and callers take their numpy paths, as in
the JAX package; ``build_error`` says why. ``native_calls`` counts the
calls that took the native code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parent / "native"
SOURCES = ("monotonic_align.cc", "indexed_dataset.cc", "yin.cc")
# the JAX package's Makefile flags, then the same without OpenMP
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
            "-Wall", "-shared")
SERIAL_CXXFLAGS = tuple(f for f in CXXFLAGS if f != "-fopenmp") + (
    "-Wno-unknown-pragmas",)

build_error: Optional[str] = None   # why a build failed
build_seconds: Optional[float] = None   # g++ wall time of this process's build
library: Optional[Path] = None   # the loaded library's file
openmp: Optional[bool] = None   # whether it was built with OpenMP
native_calls = {"yin_f0": 0, "maximum_path": 0, "read_batch": 0}


def _host_cpu() -> bytes:
    """The CPU model and feature flags ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(keep[:2])


def library_path(flags) -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join(flags).encode())
    h.update(_host_cpu())
    return BUILD_DIR / f"libmga_native_{h.hexdigest()[:12]}.so"


def _build(out: Path, flags) -> None:
    global build_seconds
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.time()
    proc = subprocess.run(
        [cxx, *flags, "-o", str(tmp),
         *(str(NATIVE_DIR / s) for s in SOURCES)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exit {proc.returncode}: {proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    build_seconds = time.time() - t0


@functools.lru_cache(maxsize=1)
def _load():
    """The built library (building it on first use), or None."""
    global build_error, library, openmp
    errors, lib = [], None
    for flags in (CXXFLAGS, SERIAL_CXXFLAGS):
        out = library_path(flags)
        try:
            if not out.exists():
                _build(out, flags)
            lib = ctypes.CDLL(str(out))
            break
        except (OSError, RuntimeError) as e:
            errors.append(str(e))
    build_error = "\n".join(errors) or None
    if lib is None:
        return None
    library, openmp = out, "-fopenmp" in flags
    c = ctypes
    lib.maximum_path_c.argtypes = [
        c.POINTER(c.c_int32), c.POINTER(c.c_float),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.c_int, c.c_int, c.c_int,
    ]
    lib.maximum_path_c.restype = None
    lib.idx_builder_open.argtypes = [c.c_char_p]
    lib.idx_builder_open.restype = c.c_void_p
    lib.idx_builder_add.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.idx_builder_add.restype = c.c_int64
    lib.idx_builder_finalize.argtypes = [c.c_void_p, c.c_char_p]
    lib.idx_builder_finalize.restype = c.c_int
    lib.idx_reader_open.argtypes = [c.c_char_p]
    lib.idx_reader_open.restype = c.c_void_p
    lib.idx_reader_len.argtypes = [c.c_void_p]
    lib.idx_reader_len.restype = c.c_int64
    lib.idx_reader_size.argtypes = [c.c_void_p, c.c_int64]
    lib.idx_reader_size.restype = c.c_int64
    lib.idx_reader_ptr.argtypes = [c.c_void_p, c.c_int64]
    lib.idx_reader_ptr.restype = c.c_void_p
    lib.idx_reader_gather.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.c_int, c.c_char_p,
        c.POINTER(c.c_int64)]
    lib.idx_reader_gather.restype = None
    lib.idx_reader_close.argtypes = [c.c_void_p]
    lib.idx_reader_close.restype = None
    lib.yin_f0_c.argtypes = [
        c.POINTER(c.c_float), c.c_int64, c.c_int, c.c_int, c.c_int,
        c.c_float, c.c_float, c.c_float, c.POINTER(c.c_float), c.c_int64]
    lib.yin_f0_c.restype = None
    return lib


def native_available() -> bool:
    """True when the library is built (building it on first call)."""
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {build_error}")
    return lib


def yin_f0_native(wav: np.ndarray, sample_rate: int = 22050, hop: int = 256,
                  frame_length: int = 2048, fmin: float = 60.0,
                  fmax: float = 1000.0, threshold: float = 0.15,
                  lp_hz: float = 4000.0) -> np.ndarray:
    """Same contract as audio.f0.yin_f0, but C++/OpenMP (native/yin.cc).
    The anti-imaging prefilter (audio.f0._yin_prefilter) runs here in numpy
    so both twins see byte-identical input."""
    lib = _lib()
    from ..audio.f0 import _yin_prefilter
    wav = _yin_prefilter(wav, sample_rate, lp_hz)
    wav = np.ascontiguousarray(np.asarray(wav).reshape(-1), dtype=np.float32)
    n_frames = 1 + len(wav) // hop
    out = np.zeros(n_frames, dtype=np.float32)
    lib.yin_f0_c(
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(len(wav)), sample_rate, hop, frame_length,
        ctypes.c_float(fmin), ctypes.c_float(fmax), ctypes.c_float(threshold),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n_frames))
    native_calls["yin_f0"] += 1
    return out


def maximum_path_native(neg_cent: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """MAS on the host (native/monotonic_align.cc): numpy float32 [B, Ty,
    Tx] -> the one-hot path, the oracle ops.maximum_path_torch and the CUDA
    kernel are held against."""
    lib = _lib()
    b, t_y, t_x = neg_cent.shape
    values = np.ascontiguousarray(neg_cent * mask, dtype=np.float32)
    paths = np.zeros((b, t_y, t_x), dtype=np.int32)
    t_ys = np.ascontiguousarray(mask[:, :, 0].sum(1), dtype=np.int32)
    t_xs = np.ascontiguousarray(mask[:, 0, :].sum(1), dtype=np.int32)
    lib.maximum_path_c(
        paths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        t_ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        t_xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b, t_y, t_x)
    native_calls["maximum_path"] += 1
    return paths.astype(np.float32) * mask
