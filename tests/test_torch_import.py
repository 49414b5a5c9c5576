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


def test_api_modules_import_without_jax():
    """The user API (Context, checkpoint, XML, profiling) loads no JAX and
    nothing of the JAX package, and the package exports it."""
    probe = """
import sys
import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.models import context
from nonbondedslicing_tpu_torch.runtime import checkpoint, profiling
from nonbondedslicing_tpu_torch.serialization import xml_proxy
names = ("Context", "Platform", "State", "VerletIntegrator", "XmlSerializer")
assert all(hasattr(nbt, name) and name in nbt.__all__ for name in names)
print(sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("nonbondedslicing_tpu.")))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


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


def test_parallel_imports_without_jax():
    """The sharded evaluation (``parallel/``) and the tests' rank helper,
    which spawned ranks import, load no JAX and nothing of the JAX
    package."""
    probe = """
import sys
from nonbondedslicing_tpu_torch.parallel import collectives, mesh, pme_shard
import torch_parallel_cases
names = ("make_sharded_compute", "make_multichip_md_step")
assert all(callable(getattr(mesh, name)) for name in names)
names = ("make_pme_device_term", "make_sharded_pme", "make_sharded_ewald")
assert all(callable(getattr(pme_shard, name)) for name in names)
print(sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("nonbondedslicing_tpu.")))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.path.join(root, "tests")]))
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
