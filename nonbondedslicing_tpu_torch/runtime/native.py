"""ctypes bridge to the native C++ host helpers (``native/nbs_native.cpp``).

The port's counterpart of the JAX package's ``runtime/native.py``, over the
port's own copy of the source.  The library is built with

    g++ -O3 -shared -fPIC -std=c++17 native/nbs_native.cpp
        -o <build dir>/libnbs_native_<srchash>.so

at first use, keyed by a hash of the source and the flags, into the
directory the CUDA kernels build into (``runtime.kernels.build_dir()``:
``$NBS_TORCH_BUILD_DIR``, the checkout's ignored
``build/nonbondedslicing_tpu_torch/``, or a user cache), never beside the
package.  It covers host work only: the legal FFT dimension search, the
O(C^2) class-pair sums of the dispersion correction, a voxel-hash
neighbor-list oracle and cell occupancy.  Every entry point has the JAX
package's pure-Python fallback, taken when the build or the load fails;
``get_lib()`` returns None then and ``LAST_BUILD["error"]`` says why.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from .kernels import build_dir

SOURCE = Path(__file__).resolve().parent.parent / "native" / "nbs_native.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

# what the last get_lib() found: the library's path, the seconds its build
# took (0.0 when an earlier build of the same source was loaded) and the
# error that left it unbuilt or unloaded
LAST_BUILD = {"path": None, "build_seconds": 0.0, "error": None}

_lock = threading.Lock()
_lib = None
_tried = False


def library_path():
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return build_dir() / f"libnbs_native_{h.hexdigest()[:16]}.so"


def _build(path):
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++"] + GXX_FLAGS + [str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("g++ failed building " + SOURCE.name + ":\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, path)


def _load(path):
    lib = ctypes.CDLL(str(path))
    lib.nbs_find_legal_dimension.restype = ctypes.c_int
    lib.nbs_find_legal_dimension.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.nbs_dispersion_corrections.restype = None
    lib.nbs_dispersion_corrections.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double)]
    lib.nbs_neighbor_pairs.restype = ctypes.c_int64
    lib.nbs_neighbor_pairs.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.nbs_max_cell_occupancy.restype = ctypes.c_int32
    lib.nbs_max_cell_occupancy.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    return lib


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            LAST_BUILD["path"] = path
            if not path.exists():
                t0 = time.perf_counter()
                _build(path)
                LAST_BUILD["build_seconds"] = time.perf_counter() - t0
            _lib = _load(path)
        except Exception as exc:       # the fallbacks take over
            LAST_BUILD["error"] = f"{type(exc).__name__}: {exc}"
            _lib = None
        return _lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def find_legal_dimension(minimum, max_factor=7):
    lib = get_lib()
    if lib is not None:
        return lib.nbs_find_legal_dimension(int(minimum), int(max_factor))
    from ..utils.ewald_params import find_legal_dimension as py_fallback
    return py_fallback(minimum, max_factor)


def dispersion_corrections(sigma, epsilon, subset, num_subsets, use_switch,
                           cutoff, switch_dist):
    """Per-slice dispersion coefficients; None if the library is
    unavailable (``ops.dispersion`` then sums the classes in Python)."""
    lib = get_lib()
    if lib is None:
        return None
    sigma = np.ascontiguousarray(sigma, dtype=np.float64)
    epsilon = np.ascontiguousarray(epsilon, dtype=np.float64)
    subset = np.ascontiguousarray(subset, dtype=np.int32)
    num_slices = num_subsets * (num_subsets + 1) // 2
    out = np.zeros(num_slices)
    lib.nbs_dispersion_corrections(
        len(sigma), _dptr(sigma), _dptr(epsilon),
        subset.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(num_subsets), int(bool(use_switch)), float(cutoff),
        float(switch_dist), _dptr(out))
    return out


def neighbor_pairs(positions, box, cutoff, periodic=True):
    """Voxel-hash neighbor list -> (M, 2) int64 array of i<j pairs within
    cutoff, or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    box = np.ascontiguousarray(box, dtype=np.float64)
    n = len(positions)
    cap = max(1024, n * 128)
    while True:
        out = np.empty((cap, 2), dtype=np.int64)
        m = lib.nbs_neighbor_pairs(
            n, _dptr(positions), _dptr(box), float(cutoff),
            int(bool(periodic)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
        if m <= cap:
            return out[:m].copy()
        cap = m


def max_cell_occupancy(positions, box, counts):
    lib = get_lib()
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    box = np.ascontiguousarray(box, dtype=np.float64)
    if lib is not None:
        return int(lib.nbs_max_cell_occupancy(
            len(positions), _dptr(positions), _dptr(box),
            int(counts[0]), int(counts[1]), int(counts[2])))
    # numpy fallback
    frac = positions @ np.linalg.inv(box).T
    frac -= np.floor(frac)
    ci = np.minimum((frac * counts).astype(int), np.asarray(counts) - 1)
    cell = (ci[:, 0] * counts[1] + ci[:, 1]) * counts[2] + ci[:, 2]
    return int(np.bincount(cell).max())
