"""Build and load the port's hand-written CUDA kernels.

The sources under ``nonbondedslicing_tpu_torch/csrc`` have plain C entry
points (no PyTorch headers).  Each ``.cu`` file is compiled to an object by
its own ``nvcc``, all of them started together, and one more ``nvcc`` links
the objects into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
         -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o      (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o
         build/nonbondedslicing_tpu_torch/libnbs_kernels_<srchash>.so *.o

The library is built at first use, keyed by a hash of the sources, and
loaded with ``ctypes``.  It goes into ``$NBS_TORCH_BUILD_DIR`` when that is
set; else, in a checkout of the repository, into its (ignored)
``build/nonbondedslicing_tpu_torch/``; else, for an installed package, into
``nonbondedslicing_tpu_torch/`` under ``$XDG_CACHE_HOME`` or ``~/.cache``.
Every pointer and the stream pass as ``c_void_p``.  Importing this module
needs neither nvcc nor a GPU; a failed build or launch raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# entry point -> argument types (all return a cudaError_t as int)
_SIGNATURES = {
    "nbs_pair_column": [_P] * 10 + [_I] * 12 + [_F] * 10 + [_I, _P],
    "nbs_pair_cell": [_P] * 10 + [_I] * 13 + [_F] * 10 + [_I, _P],
    "nbs_pair_launch_shape": [_I] * 5 + [_P],
    "nbs_pme_spread": [_P] * 5 + [_I] * 12 + [_P],
    "nbs_pme_interp": [_P] * 6 + [_I] * 5 + [_P],
    "nbs_pme_spread_windows": [_P] * 5 + [_I] * 8 + [_P],
    "nbs_pme_fold": [_P] * 2 + [_I] * 7 + [_P],
    "nbs_pme_extract": [_P] * 2 + [_I] * 7 + [_P],
    "nbs_pme_interp_windows": [_P] * 6 + [_I] * 8 + [_P],
    "nbs_water_tail": [_P] * 11 + [_I] * 2 + [_F] * 5 + [_P],
}


def build_dir():
    """Where the shared library is built (see the module docstring)."""
    override = os.environ.get("NBS_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    if (_PKG.parent / "pyproject.toml").exists():
        return _PKG.parent / "build" / "nonbondedslicing_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "nonbondedslicing_tpu_torch"


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash():
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "nonbondedslicing_tpu_torch are built with the CUDA "
                       "toolkit's nvcc")


def _compile(path):
    """Compile every source in parallel, link them into ``path``; returns
    what nvcc printed, raises if any step fails."""
    tmp_dir = path.with_name(f"{path.stem}.{os.getpid()}.objs")
    tmp_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objects, procs = [], []
    try:
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = tmp_dir / (src.stem + ".o")
            objects.append(obj)
            cmd = [nvcc] + NVCC_FLAGS + ["-c", str(src), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                failed.append(" ".join(cmd) + "\n" + out)
        if failed:
            raise RuntimeError("nvcc failed building the CUDA kernels:\n"
                               + "\n".join(failed))
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ([nvcc] + ARCH_FLAGS + ["-shared", "-o", str(tmp)]
               + [str(o) for o in objects])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("nvcc failed linking the CUDA kernels:\n"
                               + " ".join(cmd) + "\n" + proc.stdout
                               + proc.stderr)
        os.replace(tmp, path)
        return "".join(log)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp_dir, ignore_errors=True)


class KernelLibrary:
    """The built shared library.  ``build_seconds`` is the time the build
    took (0.0 when an earlier build of the same sources was found) and
    ``build_log`` what nvcc printed (``-Xptxas -v``: registers, shared
    memory and spills of every kernel)."""

    def __init__(self):
        self._lib = None
        self._lock = threading.Lock()
        self.build_seconds = 0.0
        self.build_log = ""
        self.path = None

    def build(self):
        """Compile (if needed) and load; returns the ctypes library."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            out_dir = build_dir()
            out_dir.mkdir(parents=True, exist_ok=True)
            path = out_dir / f"libnbs_kernels_{source_hash()}.so"
            if not path.exists():
                t0 = time.perf_counter()
                self.build_log = _compile(path)
                self.build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self.path = path
            self._lib = lib
            return lib

    def call(self, name, *args):
        """Launch entry point ``name`` on the given arguments; raise if the
        launch reports a CUDA error."""
        err = getattr(self.build(), name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


LIBRARY = KernelLibrary()
