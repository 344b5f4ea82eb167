"""ctypes bindings for the native IO library (``vitio.cpp``).

Counterpart of ``vit_with_opencl_tpu/runtime/native.py``, with the same
entry points and semantics: every one mirrors ``io.binfmt`` /
``harness.results`` exactly, and the tests hold the two byte for byte.

The build differs. ``g++ -O3 -march=native -shared -fPIC -std=c++17``
writes to a temporary file in ``vit_with_opencl_tpu_torch/_build/``, which
is then ``os.replace``d to a name keyed by a hash of the source, the flags
and the host CPU's feature flags (``-march=native`` depends on them). A
reader therefore finds the finished library or none, never a half-written
one, however many processes build at once; an unchanged tree on the same
kind of host loads the earlier build. Nothing is compiled at import: the
first ``get_native_io()`` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "vitio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_cached: Optional["NativeIO"] = None
_build_error: Optional[str] = None


def _cpu_flags() -> str:
    """The host CPU's feature flags (the first ``flags`` line of
    ``/proc/cpuinfo``; empty where there is none)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return ""


def library_path(build_dir: Optional[Path] = None) -> Path:
    """Where the build of this source, these flags and this CPU lives, in
    ``build_dir`` (default ``BUILD_DIR``)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_flags().encode())
    h.update(SRC.read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libvitio_{h.hexdigest()[:16]}.so"


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile ``vitio.cpp`` into ``build_dir`` (default ``BUILD_DIR``;
    once) and return the library's path. Raises ``RuntimeError`` without
    ``g++`` or when the compile fails."""
    lib = library_path(build_dir)
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: libvitio is compiled at first use")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{lib.stem}_", suffix=".so",
                               dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"vitio build failed:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a reader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


class NativeIO:
    """Thin OO wrapper over the C ABI."""

    def __init__(self, lib_path: Optional[str | os.PathLike] = None):
        self._lib = ctypes.CDLL(str(lib_path or build()))
        lib = self._lib
        lib.vitio_last_error.restype = ctypes.c_char_p
        lib.vitio_last_error.argtypes = []
        lib.vitio_load_images.restype = ctypes.POINTER(ctypes.c_float)
        lib.vitio_load_images.argtypes = [ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_int32)]
        lib.vitio_free.restype = None
        lib.vitio_free.argtypes = [ctypes.c_void_p]
        lib.vitio_load_weights.restype = ctypes.c_int
        lib.vitio_load_weights.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.vitio_write_results.restype = ctypes.c_int
        lib.vitio_write_results.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.vitio_compare_results.restype = ctypes.c_int
        lib.vitio_compare_results.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_float,
        ]

    def _error(self) -> str:
        return self._lib.vitio_last_error().decode()

    def load_images(self, path: str | os.PathLike) -> np.ndarray:
        header = (ctypes.c_int32 * 4)()
        ptr = self._lib.vitio_load_images(str(path).encode(), header)
        if not ptr:
            raise IOError(f"{path}: {self._error()}")
        n, c, h, w = header
        try:
            buf = np.ctypeslib.as_array(ptr, shape=(n * c * h * w,))
            out = buf.reshape(n, c, h, w).copy()
        finally:
            self._lib.vitio_free(ptr)
        return out

    def load_weights(
        self,
        directory: str | os.PathLike,
        count: int,
        *,
        round_to_6dp: bool = True,
        strict: bool = False,
    ) -> Dict[int, np.ndarray]:
        data = (ctypes.POINTER(ctypes.c_float) * count)()
        sizes = (ctypes.c_int64 * count)()
        rc = self._lib.vitio_load_weights(
            str(directory).encode(), count, int(round_to_6dp), int(strict),
            data, sizes,
        )
        try:
            if rc < 0:
                raise IOError(f"{directory}: {self._error()}")
            if rc > 0:
                missing = [i for i in range(count) if not data[i]]
                raise FileNotFoundError(
                    f"{directory}: missing weight indices {missing}"
                )
            out: Dict[int, np.ndarray] = {}
            for i in range(count):
                if data[i]:
                    out[i] = np.ctypeslib.as_array(
                        data[i], shape=(int(sizes[i]),)
                    ).copy()
            return out
        finally:
            for i in range(count):
                if data[i]:
                    self._lib.vitio_free(data[i])

    def write_results(self, path: str | os.PathLike, probs: np.ndarray) -> None:
        probs = np.ascontiguousarray(probs, np.float32)
        n, k = probs.shape
        rc = self._lib.vitio_write_results(str(path).encode(), probs, n, k)
        if rc != 0:
            raise IOError(f"{path}: {self._error()}")

    def compare_results(
        self,
        result_path: str | os.PathLike,
        answer_path: str | os.PathLike,
        *,
        image_count: int = -1,
        prob_tol: float = 0.01,
    ) -> int:
        rc = self._lib.vitio_compare_results(
            str(result_path).encode(), str(answer_path).encode(),
            image_count, prob_tol,
        )
        if rc < 0:
            raise IOError(self._error())
        return rc


def get_native_io() -> Optional[NativeIO]:
    """Build and load the native library; None if the toolchain is
    unavailable (the caller then uses the NumPy io layer)."""
    global _cached, _build_error
    with _lock:
        if _cached is not None:
            return _cached
        if _build_error is not None:
            return None
        try:
            _cached = NativeIO()
        except (RuntimeError, OSError) as e:
            _build_error = str(e)
            return None
        return _cached


def native_available() -> bool:
    return get_native_io() is not None
