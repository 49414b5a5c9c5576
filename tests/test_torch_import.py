"""The port imports without JAX and without a GPU or nvcc."""

import os
import subprocess
import sys

_PROBE = """
import importlib, pkgutil, sys
import nonbondedslicing_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
                or m.startswith("nonbondedslicing_tpu."))
print(len(names), leaked)
"""


def test_port_imports_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, leaked = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20, out.stdout
    assert leaked == "[]", out.stdout


def test_kernel_build_is_lazy():
    """Importing the kernel loader compiles nothing; the library exists only
    after a CUDA launch asks for it."""
    from nonbondedslicing_tpu_torch.runtime import kernels
    assert kernels.CSRC_DIR.is_dir()
    names = {p.name for p in kernels.CSRC_DIR.glob("*.cu")}
    assert names == {"pair_column.cu", "pair_cell.cu", "pme_spread.cu",
                     "pme_interp.cu", "pme_spread_windows.cu", "pme_fold.cu",
                     "pme_extract.cu", "pme_interp_windows.cu"}
    # one entry point per source, and the pair kernels' launch-shape query
    assert {"nbs_" + n[:-3] for n in names} == (
        set(kernels._SIGNATURES) - {"nbs_pair_launch_shape"})
    assert len(kernels.source_hash()) == 16
