"""ctypes bindings and on-demand build of the native runtime (C++).

Counterpart of gl_slam_tpu/runtime/native_lib.py, with its names and
signatures: `load`, `available`, `NativeLoader`, `decode_png`,
`CovisGraph`. The port keeps its own sources (native/) and builds them
into two libraries, each linking nothing but the C++ runtime:

  * the loader, native/dataloader.cpp, with its own PNG reader and
    inflate, so it builds wherever g++ does (no libpng, no zlib);
  * the covisibility graph, native/covis_graph.cpp.

Each is built at first use with `g++ -O3 -std=c++17 -pthread` into
`runtime/build/` (listed in .gitignore), under a name that carries a hash
of its source and flags, so an edited source is rebuilt and a stale
library is never loaded. A build writes a temporary file of its own and
renames it into place, so several processes may build at once. A failed
build, or a library that does not load here (built on another machine,
for another C++ runtime), is remembered for the process: `load()` then
returns None and `available()` False (the command line reads frames with
PIL), while `CovisGraph` raises; `build_error()` gives the reason.

`DELIVERED["frames"]` counts the frames every `NativeLoader` delivered,
in the manner of the kernels' launch counters (ops/_build.LAUNCHES).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "native")
BUILD_DIR = os.path.join(_DIR, "build")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]
# library -> (source, link flags)
_LIBS = {"loader": ("dataloader.cpp", []),
         "covis": ("covis_graph.cpp", [])}

_LOCK = threading.Lock()
_LOADED: dict = {}
_FAILED: dict = {}

DELIVERED = {"frames": 0}


def reset_frame_count() -> None:
    DELIVERED["frames"] = 0


def library_path(name: str) -> str:
    """The library `name` ("loader" or "covis"), named by a hash of its
    source and of the compiler and link flags."""
    src, link = _LIBS[name]
    with open(os.path.join(_SRC, src), "rb") as fh:
        h = hashlib.sha256(fh.read())
    h.update(" ".join(CXX_FLAGS + link).encode())
    return os.path.join(BUILD_DIR, f"libglslam_{name}-{h.hexdigest()[:16]}.so")


def _build(name: str, so: str) -> Optional[str]:
    """Compile library `name` into `so`; None on success, else the
    compiler's message."""
    src, link = _LIBS[name]
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", *CXX_FLAGS, os.path.join(_SRC, src), *link, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, so)
        return None
    except subprocess.CalledProcessError as e:
        return (e.stderr or str(e)).strip()
    except (subprocess.SubprocessError, OSError) as e:
        return str(e)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind_loader(lib: ctypes.CDLL) -> None:
    lib.glslam_decode_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int]
    lib.glslam_decode_png.restype = ctypes.c_int
    lib.glslam_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.glslam_loader_create.restype = ctypes.c_void_p
    lib.glslam_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.glslam_loader_next.restype = ctypes.c_long
    lib.glslam_loader_destroy.argtypes = [ctypes.c_void_p]


def _bind_covis(lib: ctypes.CDLL) -> None:
    lib.covis_create.argtypes = [ctypes.c_long]
    lib.covis_create.restype = ctypes.c_void_p
    lib.covis_destroy.argtypes = [ctypes.c_void_p]
    lib.covis_add_keyframe.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long),
        ctypes.c_long]
    lib.covis_query.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.c_long]
    lib.covis_query.restype = ctypes.c_long
    lib.covis_points_of.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.c_long]
    lib.covis_points_of.restype = ctypes.c_long
    lib.covis_num_edges.argtypes = [ctypes.c_void_p]
    lib.covis_num_edges.restype = ctypes.c_long


def _load(name: str) -> Optional[ctypes.CDLL]:
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        if name in _FAILED:
            return None
        so = library_path(name)
        if not os.path.exists(so):
            err = _build(name, so)
            if err is not None:
                _FAILED[name] = err
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:        # built elsewhere, for a runtime this
            _FAILED[name] = str(e)  # machine lacks
            return None
        (_bind_loader if name == "loader" else _bind_covis)(lib)
        _LOADED[name] = lib
        return lib


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the PNG loader library; None if it
    cannot be built here (no g++)."""
    return _load("loader")


def available() -> bool:
    """True when the native PNG loader is built and loaded."""
    return load() is not None


def build_error(name: str = "loader") -> Optional[str]:
    """Why library `name` is unavailable in this process (the compiler's
    or the dynamic loader's message), or None."""
    return _FAILED.get(name)


def _load_covis() -> ctypes.CDLL:
    lib = _load("covis")
    if lib is None:
        raise RuntimeError("native covisibility graph unavailable: "
                           + (build_error("covis") or ""))
    return lib


class NativeLoader:
    """Threaded native PNG prefetcher; in-order frame delivery.

    Iterating yields (index into `paths`, (height, width) float32 frame in
    [0, 1]) for every frame that decodes; a frame that does not decode is
    skipped. `threads` workers keep up to `depth` decoded frames ahead of
    the consumer."""

    def __init__(self, paths: Sequence[str], height: int, width: int,
                 depth: int = 4, threads: int = 2):
        lib = load()
        if lib is None:
            raise RuntimeError("native runtime unavailable: "
                               + (build_error() or ""))
        self._lib = lib
        self.h, self.w = height, width
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.glslam_loader_create(arr, len(paths), height,
                                                width, depth, threads)
        self._buf = np.zeros((height, width), np.float32)

    def __iter__(self):
        while True:
            idx = self._lib.glslam_loader_next(
                self._handle,
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if idx == -1:
                return
            if idx == -2:
                continue
            DELIVERED["frames"] += 1
            yield int(idx), self._buf.copy()

    def close(self):
        if self._handle:
            self._lib.glslam_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_png(path: str, height: int, width: int) -> Optional[np.ndarray]:
    """One PNG as a (height, width) float32 gray frame in [0, 1], cropped
    or zero-padded at the bottom and right; None when the library is
    unavailable or the file does not decode."""
    lib = load()
    if lib is None:
        return None
    out = np.zeros((height, width), np.float32)
    rc = lib.glslam_decode_png(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        height, width)
    return out if rc == 0 else None


class CovisGraph:
    """Exact covisibility graph (native); the unbounded host-side
    counterpart of slam/state.py's top-C device table."""

    def __init__(self, edge_threshold: int = 50):
        self._lib = _load_covis()
        self._g = self._lib.covis_create(edge_threshold)

    def add_keyframe(self, kf: int, mpids: np.ndarray):
        """Register keyframe `kf` with the map points it observes (ids < 0
        are ignored)."""
        m = np.ascontiguousarray(mpids, np.int64)
        self._lib.covis_add_keyframe(
            self._g, kf, m.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            len(m))

    def query(self, seed_mpids: np.ndarray, k1: int = 20, k2: int = 50,
              top_n: int = 5, max_out: int = 128) -> np.ndarray:
        """Keyframes of the K1/K2 retrieval from the seed points."""
        s = np.ascontiguousarray(seed_mpids, np.int64)
        out = np.zeros(max_out, np.int64)
        n = self._lib.covis_query(
            self._g, s.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            len(s), k1, k2, top_n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), max_out)
        return out[:n]

    def points_of(self, kfs: np.ndarray, exclude: np.ndarray,
                  max_out: int = 2048) -> np.ndarray:
        """The points of keyframes `kfs` not in `exclude`, each once."""
        k = np.ascontiguousarray(kfs, np.int64)
        e = np.ascontiguousarray(exclude, np.int64)
        out = np.zeros(max_out, np.int64)
        n = self._lib.covis_points_of(
            self._g, k.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), len(k),
            e.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), len(e),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), max_out)
        return out[:n]

    @property
    def num_edges(self) -> int:
        return int(self._lib.covis_num_edges(self._g))

    def __del__(self):
        try:
            self._lib.covis_destroy(self._g)
        except Exception:
            pass
