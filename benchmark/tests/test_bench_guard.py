"""A run refuses to print a result once JAX or the JAX package is loaded;
the port's own name, which begins with the JAX package's, is not refused."""

import sys
import types

from harness.guard import forbidden_modules


def test_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "nonbondedslicing_tpu", "nonbondedslicing_tpu.ops.pme",
             "nonbondedslicing_tpu_torch", "nonbondedslicing_tpu_torch.ops",
             "jaxtyping", "numpy"]
    assert forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "nonbondedslicing_tpu", "nonbondedslicing_tpu.ops.pme"])


def test_the_port_loads_no_jax():
    import nonbondedslicing_tpu_torch  # noqa: F401
    import run  # noqa: F401
    from harness import check, client, spec, trace  # noqa: F401
    assert not [m for m in forbidden_modules()
                if m.split(".")[0] == "nonbondedslicing_tpu"]


def test_run_exits_when_jax_is_loaded(tiny_run, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    code, result = tiny_run("water23k-pme.dhdl500", seconds=0.0)
    assert code != 0 and result is None
