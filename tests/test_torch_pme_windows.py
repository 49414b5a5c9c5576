"""The brick-window PME pipeline (``pme_pipeline="grid"``): plain twins of
the window spread, fold, extract and window interpolation kernels against
the JAX package's Pallas kernels in interpret mode and its XLA brick oracle
(``ops/pme_bricks.py``), and ``pme_reciprocal(pipeline="grid")`` against
``pme_reciprocal_pallas`` under ``NBS_PME_PIPELINE=grid``.

Tolerances: the fold and extract twins equal the interpret-mode kernels to
the bit (same additions in the same order; a copy).  The float32 spread and
interpolation twins differ from the Pallas kernels by the rounding of their
sums: 2e-6 of the largest window value for the spread (the kernels' MXU
product set to full float32), 2e-5 of (max|F| + 1) for the forces, the
budget of tests/test_pallas_pme.py.  Float64 comparisons hold to 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonbondedslicing_tpu.ops import fused as jfused
from nonbondedslicing_tpu.ops import pallas_pme
from nonbondedslicing_tpu.ops import pme as jpme
from nonbondedslicing_tpu.ops import pme_bricks as jbricks
from nonbondedslicing_tpu.utils.indexing import slice_pair_table, slice_subsets

from nonbondedslicing_tpu_torch.ops import cuda_pme
from nonbondedslicing_tpu_torch.ops import neighbors as tneighbors
from nonbondedslicing_tpu_torch.ops import pme as tpme
from nonbondedslicing_tpu_torch.ops import pme_bricks as tbricks

torch.set_num_threads(2)

BOX = 4.2
ALPHA = 2.8
# (bricks, grid, nsub): p = (8, 7, 7) and p = 8, all >= order + 1
LAYOUTS = {"uneven": ((2, 3, 2), (16, 21, 14), 2),
           "cubic": ((2, 2, 2), (16, 16, 16), 3)}
layouts = pytest.mark.parametrize("layout", sorted(LAYOUTS))


def _windows(layout, seed=5):
    """Random float32 windows (bx, by, bz, nsub, wx, wy, wz)."""
    bricks, grid, nsub = LAYOUTS[layout]
    w = tuple(w for _, w in tbricks.brick_window(grid, bricks))
    rng = np.random.default_rng(seed)
    return rng.normal(size=bricks + (nsub,) + w).astype(np.float32)


def _slots(layout, dtype, n=400, capacity=96, seed=12, counts=None,
           shift=0.0):
    """Slot tensors of ``n`` random charges sorted into ``counts`` cells
    (the bricks by default), and the same as the JAX kernels take them.
    The slot table is built at the drawn positions; ``shift`` (nm) then
    moves every atom along (1, 1, 1) without rebuilding it."""
    bricks, grid, nsub = LAYOUTS[layout]
    counts = counts or bricks
    rng = np.random.default_rng(seed)
    positions = rng.random((n, 3)) * BOX
    charge = rng.normal(size=n)
    subsets = rng.integers(0, nsub, n)
    box = torch.as_tensor(np.diag([BOX] * 3)).to(dtype)
    pos = torch.as_tensor(positions).to(dtype)
    cell = tneighbors.cell_ids(pos, box, counts)
    table, ov = tneighbors.build_occupancy(cell, n, counts, capacity)
    assert int(ov) == 0
    slots = table.reshape(-1).long()
    g = counts[0] * counts[1] * counts[2]
    pos_p = torch.cat([pos + shift, pos.new_zeros((1, 3))])
    q_p = torch.cat([torch.as_tensor(charge).to(dtype), pos.new_zeros(1)])
    sub_p = torch.cat([torch.as_tensor(subsets),
                       torch.zeros(1, dtype=torch.int64)])
    out = dict(
        box=box, recip=torch.linalg.inv(box).T, n=n, slots=slots,
        pos=pos_p[slots].reshape(g, capacity, 3).transpose(1, 2).contiguous(),
        q=q_p[slots].reshape(g, capacity),
        sub=sub_p[slots].reshape(g, capacity).to(torch.int32))
    jdt = np.float32 if dtype == torch.float32 else np.float64
    real = (slots < n).reshape(g, 1, capacity).numpy()
    soh = (out["sub"].numpy()[:, None, :] == np.arange(nsub)[None, :, None])
    out.update(
        pos_j=jnp.asarray(out["pos"].numpy(), jdt),
        q_j=jnp.asarray(out["q"].numpy(), jdt),
        soh_j=jnp.asarray((soh & real).astype(jdt)),
        box_j=jnp.asarray(np.diag([BOX] * 3), jdt))
    return out


def _flat(W, layout):
    """(bx, by, bz, nsub, wx, wy, wz) -> the JAX kernels' (g, nsub*wx,
    wy*wz)."""
    bricks, _, nsub = LAYOUTS[layout]
    g = bricks[0] * bricks[1] * bricks[2]
    wx, wy, wz = W.shape[4:]
    return np.asarray(W).reshape(g, nsub * wx, wy * wz)


# ------------------------------------------------------------ fold, extract

@layouts
def test_fold_twin_equals_pallas_fold_kernel(layout):
    bricks, grid, nsub = LAYOUTS[layout]
    W = _windows(layout)
    fold_j = pallas_pme.make_fold_kernel(grid_shape=grid, bricks=bricks,
                                         nsub=nsub, interpret=True)
    grid_j = np.asarray(fold_j(jnp.asarray(W)))
    grid_t = cuda_pme.pme_fold(torch.as_tensor(W))
    assert grid_t.dtype == torch.float32
    np.testing.assert_array_equal(grid_t.numpy(), grid_j)


@layouts
def test_fold_twin_is_the_shifted_scatter(layout):
    """fold = roll(scatter_windows, +1): 1e-6 (another order of additions)."""
    bricks, grid, nsub = LAYOUTS[layout]
    W = _windows(layout)
    g = bricks[0] * bricks[1] * bricks[2]
    ref = np.asarray(jbricks.scatter_windows(
        jnp.asarray(W).reshape((g, nsub) + W.shape[4:]), bricks, grid))
    np.testing.assert_allclose(
        cuda_pme.pme_fold(torch.as_tensor(W)).numpy(),
        np.roll(ref, (1, 1, 1), axis=(1, 2, 3)), rtol=1e-6, atol=1e-6)


@layouts
def test_extract_twin_equals_pallas_extract_kernel(layout):
    bricks, grid, nsub = LAYOUTS[layout]
    rng = np.random.default_rng(8)
    phi = rng.normal(size=(nsub,) + grid).astype(np.float32)
    extract_j = pallas_pme.make_extract_kernel(grid_shape=grid, bricks=bricks,
                                               nsub=nsub, interpret=True)
    W_t = cuda_pme.pme_extract(torch.as_tensor(phi), bricks)
    np.testing.assert_array_equal(W_t.numpy(),
                                  np.asarray(extract_j(jnp.asarray(phi))))


@layouts
def test_extract_of_fold_is_gather_windows(layout):
    """extract(fold(W)) is gather_windows of the unshifted grid: a copy."""
    bricks, grid, nsub = LAYOUTS[layout]
    W = torch.as_tensor(_windows(layout))
    shifted = cuda_pme.pme_fold(W)
    W_t = cuda_pme.pme_extract(shifted, bricks)
    true_grid = np.roll(shifted.numpy(), (-1, -1, -1), axis=(1, 2, 3))
    ref = np.asarray(jbricks.gather_windows(jnp.asarray(true_grid), bricks))
    g = bricks[0] * bricks[1] * bricks[2]
    np.testing.assert_array_equal(
        W_t.numpy().reshape((g, nsub) + tuple(W.shape[4:])), ref)


# ------------------------------------------------ spread and interpolation

@layouts
@pytest.mark.parametrize("shift_points", [0.0, 2.5])
def test_spread_windows_twin_matches_pallas_spread_kernel(
        monkeypatch, layout, shift_points):
    """float32, 2e-6 of the largest window value.  With the atoms moved by
    2.5 grid spacings after the slot table was built, stencil points fall
    outside their brick's window and drop out on both sides."""
    monkeypatch.setattr(pallas_pme, "_DOT_SCHEME", "highest")
    bricks, grid, nsub = LAYOUTS[layout]
    s = _slots(layout, torch.float32, shift=shift_points * BOX / grid[0])
    spread_j = pallas_pme.make_spread_kernel(grid_shape=grid, bricks=bricks,
                                             nsub=nsub, interpret=True)
    W_j = np.asarray(spread_j(s["pos_j"], s["soh_j"] * s["q_j"][:, None, :],
                              jnp.asarray(s["recip"].numpy())))
    W_t = cuda_pme.pme_spread_windows(s["pos"], s["q"], s["sub"], s["recip"],
                                      grid, bricks, nsub)
    assert W_t.shape == bricks + (nsub,) + tuple(
        w for _, w in tbricks.brick_window(grid, bricks))
    np.testing.assert_allclose(_flat(W_t, layout), W_j, rtol=0,
                               atol=2e-6 * np.abs(W_j).max())
    # every spline weight sums to 1: the windows hold the subsets' charges
    # unless points were dropped
    q_sub = np.asarray([float(s["q"][s["sub"] == k].sum())
                        for k in range(nsub)])
    kept = np.abs(W_t.sum(dim=(0, 1, 2, 4, 5, 6)).numpy() - q_sub) < 1e-4
    assert kept.all() if shift_points == 0.0 else not kept.any()


@layouts
def test_folded_windows_are_the_charge_grid_f64(layout):
    """The grid-equality test: roll(fold(spread_windows), -1) is the grid of
    the JAX brick oracle and of the port's whole-grid spread, to 1e-10."""
    bricks, grid, nsub = LAYOUTS[layout]
    s = _slots(layout, torch.float64)
    W = cuda_pme.pme_spread_windows(s["pos"], s["q"], s["sub"], s["recip"],
                                    grid, bricks, nsub)
    grid_w = torch.roll(cuda_pme.pme_fold(W), (-1, -1, -1), (1, 2, 3)).numpy()
    grid_j = np.asarray(jbricks.spread_bricks(
        s["pos_j"], s["soh_j"] * s["q_j"][:, None, :], s["box_j"], bricks,
        grid))
    grid_s = cuda_pme.pme_spread_plain(s["pos"], s["q"], s["sub"], s["recip"],
                                       grid, nsub).numpy()
    scale = np.abs(grid_s).max()
    np.testing.assert_allclose(grid_w, grid_j, rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(grid_w, grid_s, rtol=0, atol=1e-10 * scale)


@layouts
@pytest.mark.parametrize("shift_points", [0.0, 2.5])
def test_interp_windows_twin_matches_pallas_interp_kernel(layout,
                                                          shift_points):
    """float32, 2e-5 * (max|F| + 1), dropped points included."""
    bricks, grid, nsub = LAYOUTS[layout]
    s = _slots(layout, torch.float32, shift=shift_points * BOX / grid[0])
    # a smooth potential: the windows of a transformed, damped charge grid
    rng = np.random.default_rng(3)
    spec = np.fft.rfftn(rng.normal(size=(nsub,) + grid), axes=(1, 2, 3))
    k2 = sum(np.minimum(k, n - k) ** 2 for k, n in zip(
        np.meshgrid(*[np.arange(n) for n in grid], indexing="ij"), grid))
    damp = np.exp(-0.15 * k2)[..., :grid[2] // 2 + 1]
    phi = np.fft.irfftn(spec * damp, s=grid, axes=(1, 2, 3)) * 50.0
    W_phi = cuda_pme.pme_extract(torch.as_tensor(phi, dtype=torch.float32),
                                 bricks)
    interp_j = pallas_pme.make_interp_kernel(grid_shape=grid, bricks=bricks,
                                             nsub=nsub, interpret=True)
    f_j = np.asarray(interp_j(jnp.asarray(_flat(W_phi, layout)), s["pos_j"],
                              s["soh_j"], s["q_j"][:, None, :],
                              jnp.asarray(s["recip"].numpy())))
    f_t = cuda_pme.pme_interp_windows(W_phi, s["pos"], s["q"], s["sub"],
                                      s["recip"]).numpy()
    assert np.abs(f_j).max() > 1.0
    np.testing.assert_allclose(f_t, f_j, rtol=0,
                               atol=2e-5 * (np.abs(f_j).max() + 1.0))


# ------------------------------------------------------------ the pipeline

def _reciprocal(s, layout, lam, dtype, pipeline, bricks=None):
    _, grid, nsub = LAYOUTS[layout]
    eterm = torch.as_tensor(tpme.coulomb_eterm_np(
        grid, tpme.bspline_moduli(grid), np.diag([BOX] * 3), ALPHA)).to(dtype)
    lam_nn = torch.as_tensor(lam[slice_pair_table(nsub)]).to(dtype)
    return cuda_pme.pme_reciprocal(
        s["pos"], s["q"], s["sub"], s["box"], lam_nn, grid_shape=grid,
        eterm=eterm, slice_subset_pairs=torch.as_tensor(slice_subsets(nsub)),
        pipeline=pipeline, bricks=bricks)


@layouts
def test_grid_pipeline_matches_pallas_grid_pipeline_f32(monkeypatch, layout):
    """Against pme_reciprocal_pallas under NBS_PME_PIPELINE=grid (fold and
    extract kernels in interpret mode) at the tolerances of
    tests/test_pallas_pme.py:50-54."""
    monkeypatch.setenv("NBS_PME_PIPELINE", "grid")
    bricks, grid, nsub = LAYOUTS[layout]
    s = _slots(layout, torch.float32)
    lam = np.random.default_rng(2).random(nsub * (nsub + 1) // 2)
    e_t, f_t = _reciprocal(s, layout, lam, torch.float32, "grid", bricks)
    e_j, f_j = pallas_pme.pme_reciprocal_pallas(
        s["pos_j"], s["q_j"], s["soh_j"], s["box_j"],
        jnp.asarray(lam, jnp.float32), alpha=ALPHA, grid_shape=grid,
        moduli=jpme.bspline_moduli(grid), bricks=bricks,
        slice_subset_pairs=jnp.asarray(slice_subsets(nsub)),
        slice_table=slice_pair_table(nsub).astype(np.int32), interpret=True)
    f_j = np.asarray(f_j).swapaxes(1, 2)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=2e-5)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0,
                               atol=2e-5 * (np.abs(f_j).max() + 1.0))


@layouts
def test_grid_pipeline_f64_matches_brick_oracle_and_stencil(layout):
    """float64, 1e-10: against the JAX brick oracle and against the port's
    default pipeline.  The slice energies taken from the folded, shifted
    grid's spectra equal the pipeline's (from the unshifted double spread):
    the shift is a pure phase, which cancels."""
    bricks, grid, nsub = LAYOUTS[layout]
    s = _slots(layout, torch.float64)
    lam = np.random.default_rng(2).random(nsub * (nsub + 1) // 2)
    e_g, f_g = _reciprocal(s, layout, lam, torch.float64, "grid", bricks)
    e_s, f_s = _reciprocal(s, layout, lam, torch.float64, "stencil")
    e_o, f_o = jbricks.pme_reciprocal_bricks(
        s["pos_j"], s["q_j"], s["soh_j"], s["box_j"], jnp.asarray(lam),
        alpha=ALPHA, grid_shape=grid, moduli=jpme.bspline_moduli(grid),
        counts=bricks, slice_subset_pairs=jnp.asarray(slice_subsets(nsub)),
        slice_table=slice_pair_table(nsub).astype(np.int32))
    f_o = np.asarray(f_o).swapaxes(1, 2)
    scale = np.abs(f_o).max()
    np.testing.assert_allclose(e_g.numpy(), np.asarray(e_o), rtol=1e-10)
    np.testing.assert_allclose(f_g.numpy(), f_o, rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(e_g.numpy(), e_s.numpy(), rtol=1e-10)
    np.testing.assert_allclose(f_g.numpy(), f_s.numpy(), rtol=0,
                               atol=1e-10 * scale)
    shifted = cuda_pme.pme_fold(cuda_pme.pme_spread_windows(
        s["pos"], s["q"], s["sub"], s["recip"], grid, bricks, nsub))
    spec = torch.fft.rfftn(shifted, dim=(1, 2, 3))
    eterm = torch.as_tensor(tpme.coulomb_eterm_np(
        grid, tpme.bspline_moduli(grid), np.diag([BOX] * 3), ALPHA))
    e_shifted = tpme.pme_slice_energies_ri(
        spec.real, spec.imag,
        eterm * tpme.rfft_energy_weights(grid[2], "cpu"),
        torch.as_tensor(slice_subsets(nsub)))
    np.testing.assert_allclose(e_shifted.numpy(), e_g.numpy(), rtol=1e-10)


# -------------------------------------------- bricks of several cells (f = 2)

CELLS = (4, 4, 4)


def test_brick_regrouping_equals_jax():
    """cells_to_bricks / bricks_to_cells equal the JAX package's to the bit
    and invert each other, at cells (4, 4, 4), bricks (2, 2, 2)."""
    bricks = (2, 2, 2)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 3, 10)).astype(np.float32)
    x_b = tbricks.cells_to_bricks(torch.as_tensor(x), CELLS, bricks)
    assert x_b.shape == (8, 3, 80)
    np.testing.assert_array_equal(
        x_b.numpy(),
        np.asarray(jfused._cells_to_bricks(jnp.asarray(x), CELLS, bricks)))
    y = rng.normal(size=(8, 80, 3)).astype(np.float32)
    y_c = tbricks.bricks_to_cells(torch.as_tensor(y), CELLS, bricks)
    assert y_c.shape == (64, 10, 3)
    np.testing.assert_array_equal(
        y_c.numpy(),
        np.asarray(jfused._bricks_to_cells(jnp.asarray(y), CELLS, bricks)))
    back = tbricks.bricks_to_cells(x_b.transpose(1, 2), CELLS, bricks)
    np.testing.assert_array_equal(back.transpose(1, 2).numpy(), x)


def test_grid_pipeline_on_bricks_of_eight_cells():
    """Cell-major slots of a (4, 4, 4) cell grid regrouped into (2, 2, 2)
    bricks (8 cells, 8 * C slots each): the window pipeline's forces, back
    in cell order, equal the default pipeline's on the cell-major slots, in
    float64 to 1e-10."""
    layout = "cubic"
    bricks, grid, nsub = LAYOUTS[layout]
    s = _slots(layout, torch.float64, capacity=24, counts=CELLS)
    lam = np.random.default_rng(2).random(nsub * (nsub + 1) // 2)
    e_s, f_s = _reciprocal(s, layout, lam, torch.float64, "stencil")
    b = dict(s, pos=tbricks.cells_to_bricks(s["pos"], CELLS,
                                            bricks).contiguous(),
             q=tbricks.cells_to_bricks(s["q"][:, None], CELLS, bricks)[:, 0],
             sub=tbricks.cells_to_bricks(s["sub"][:, None], CELLS,
                                         bricks)[:, 0])
    assert b["pos"].shape == (8, 3, 8 * 24)
    e_g, f_gb = _reciprocal(b, layout, lam, torch.float64, "grid", bricks)
    f_g = tbricks.bricks_to_cells(f_gb.transpose(1, 2), CELLS,
                                  bricks).transpose(1, 2)
    np.testing.assert_allclose(e_g.numpy(), e_s.numpy(), rtol=1e-10)
    np.testing.assert_allclose(f_g.numpy(), f_s.numpy(), rtol=0,
                               atol=1e-10 * float(f_s.abs().max()))


# ------------------------------------------------------------------ refusals

@pytest.mark.parametrize("call", ["fold", "extract", "spread", "reciprocal"])
def test_windows_wider_than_two_bricks_raise(call):
    """grid (8, 8, 8) over bricks (2, 2, 2): p = 4, w = 10 > 2p.  The JAX
    package falls back to another pipeline there; the port raises and names
    the default pipeline."""
    bricks, grid, nsub = (2, 2, 2), (8, 8, 8), 2
    pos = torch.rand(8, 3, 16, dtype=torch.float64) * BOX
    q = torch.ones(8, 16, dtype=torch.float64)
    sub = torch.zeros(8, 16, dtype=torch.int32)
    box = torch.eye(3, dtype=torch.float64) * BOX
    with pytest.raises(ValueError, match="stencil"):
        if call == "fold":
            cuda_pme.pme_fold(torch.zeros(bricks + (nsub, 10, 10, 10)))
        elif call == "extract":
            cuda_pme.pme_extract(torch.zeros((nsub,) + grid), bricks)
        elif call == "spread":
            cuda_pme.pme_spread_windows(pos, q, sub, torch.linalg.inv(box).T,
                                        grid, bricks, nsub)
        else:
            cuda_pme.pme_reciprocal(
                pos, q, sub, box, torch.ones(nsub, nsub, dtype=torch.float64),
                grid_shape=grid, eterm=torch.ones(8, 8, 5),
                slice_subset_pairs=torch.as_tensor(slice_subsets(nsub)),
                pipeline="grid",
                bricks=bricks)


def test_pipeline_arguments_are_checked():
    s = _slots("cubic", torch.float64)
    lam = np.ones(6)
    with pytest.raises(ValueError, match="pipeline must be one of"):
        _reciprocal(s, "cubic", lam, torch.float64, "windows")
    with pytest.raises(ValueError, match="needs the bricks"):
        _reciprocal(s, "cubic", lam, torch.float64, "grid")
