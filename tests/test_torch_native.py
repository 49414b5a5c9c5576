"""The port's native C++ host helpers (``runtime/native.py`` over its own
``native/nbs_native.cpp``), the twin of tests/test_native.py: each of the
four entry points against the port's pure-Python fallback (taken where the
library is missing; ``get_lib`` patched to None) and against the JAX
package's native library.  The neighbor list has no Python fallback in
either package (None without the library): a brute-force list stands in."""

import numpy as np
import pytest

import nonbondedslicing_tpu as nbs
from nonbondedslicing_tpu.runtime import native as jnative

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops.dispersion import \
    calc_dispersion_corrections
from nonbondedslicing_tpu_torch.runtime import kernels, native


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native library unavailable (no toolchain): "
                    f"{native.LAST_BUILD['error']}")
    if jnative.get_lib() is None:
        pytest.skip("the JAX package's native library is unavailable")
    return lib


def test_builds_into_the_build_dir(lib):
    """Built from the port's own source, keyed by its hash, into the
    kernels' build directory, not beside the package."""
    path = native.LAST_BUILD["path"]
    assert native.LAST_BUILD["error"] is None and path.exists()
    assert path == native.library_path()
    assert path.parent == kernels.build_dir()
    assert native.SOURCE.parent.parent.name == "nonbondedslicing_tpu_torch"
    assert not any(native.SOURCE.parent.parent.rglob("*.so"))


def test_legal_dimension(lib, monkeypatch):
    want = [jnative.find_legal_dimension(minimum, mf)
            for minimum in (1, 5, 6, 97, 121, 144, 1009) for mf in (7, 13)]
    got = [native.find_legal_dimension(minimum, mf)
           for minimum in (1, 5, 6, 97, 121, 144, 1009) for mf in (7, 13)]
    monkeypatch.setattr(native, "get_lib", lambda: None)
    slow = [native.find_legal_dimension(minimum, mf)
            for minimum in (1, 5, 6, 97, 121, 144, 1009) for mf in (7, 13)]
    assert got == want == slow


def _dispersion_force(api):
    """200 particles in 3 subsets, 12 (sigma, epsilon) classes, a switch."""
    force = api.SlicedNonbondedForce(3)
    force.setNonbondedMethod(api.SlicedNonbondedForce.CutoffPeriodic)
    force.setCutoffDistance(1.0)
    force.setUseSwitchingFunction(True)
    force.setSwitchingDistance(0.85)
    n = 200
    sigma = 0.2 + 0.2 * (np.arange(n) % 4)
    epsilon = 0.1 + 0.3 * (np.arange(n) % 3)
    subset = (np.arange(n) % 3).astype(np.int32)
    for i in range(n):
        force.addParticle(0.0, float(sigma[i]), float(epsilon[i]))
        force.setParticleSubset(i, int(subset[i]))
    return force, sigma, epsilon, subset


def test_dispersion_matches_python(lib, monkeypatch):
    """The native class sums against the port's Python loop and against
    the JAX package's library, to 1e-8 relative as tests/test_native.py
    holds its own: class order and FMA contraction differ between the
    C++ and Python paths and between the two builds (the JAX package's
    takes -march=native), and the switch integral cancels."""
    force, sigma, epsilon, subset = _dispersion_force(nbt)
    nat = calc_dispersion_corrections(force)
    np.testing.assert_allclose(
        nat, native.dispersion_corrections(sigma, epsilon, subset, 3, True,
                                           1.0, 0.85), rtol=0, atol=0)
    np.testing.assert_allclose(
        nat, jnative.dispersion_corrections(sigma, epsilon, subset, 3, True,
                                            1.0, 0.85), rtol=1e-8)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.dispersion_corrections(sigma, epsilon, subset, 3, True,
                                         1.0, 0.85) is None
    py = calc_dispersion_corrections(force)
    np.testing.assert_allclose(nat, py, rtol=1e-8)
    # and the JAX package's Python loop on its own force
    from nonbondedslicing_tpu.ops import dispersion as jdisp
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    np.testing.assert_allclose(
        py, jdisp.calc_dispersion_corrections(_dispersion_force(nbs)[0]),
        rtol=1e-14)


@pytest.mark.parametrize("periodic", [True, False])
def test_neighbor_pairs_vs_brute_force(lib, periodic, monkeypatch):
    rng = np.random.default_rng(11)
    n = 400
    box = np.diag([4.0, 3.5, 3.8])
    pos = rng.random((n, 3)) * 3.4
    cutoff = 0.9
    pairs = native.neighbor_pairs(pos, box, cutoff, periodic=periodic)
    np.testing.assert_array_equal(
        pairs, jnative.neighbor_pairs(pos, box, cutoff, periodic=periodic))
    got = {tuple(p) for p in pairs.tolist()}
    dr = pos[:, None, :] - pos[None, :, :]
    if periodic:
        for d in range(3):
            w = box[d, d]
            dr[..., d] -= w * np.floor(dr[..., d] / w + 0.5)
    r2 = np.sum(dr * dr, axis=-1)
    want = {(i, j) for i in range(n) for j in range(i + 1, n)
            if r2[i, j] < cutoff * cutoff}
    assert got == want
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.neighbor_pairs(pos, box, cutoff, periodic) is None


def test_max_cell_occupancy(lib, monkeypatch):
    rng = np.random.default_rng(3)
    pos = rng.random((500, 3)) * 5.0
    box = np.diag([5.0, 5.0, 5.0])
    for counts in ((5, 5, 5), (3, 4, 6)):
        nat = native.max_cell_occupancy(pos, box, counts)
        assert nat == jnative.max_cell_occupancy(pos, box, counts)
        with monkeypatch.context() as m:
            m.setattr(native, "get_lib", lambda: None)
            assert native.max_cell_occupancy(pos, box, counts) == nat
