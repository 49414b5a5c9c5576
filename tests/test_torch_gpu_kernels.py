"""CUDA kernels of the port vs their plain PyTorch twins, on the card.

Marked ``gpu``; they skip (from inside the fixture) where no CUDA device is
present.  On a machine with an H100:

    python -m pytest -m gpu tests/test_torch_gpu_kernels.py
"""

import numpy as np
import pytest
import torch

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import cuda_direct, cuda_pme
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import fused as tfused
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.ops import pme as tpme
from nonbondedslicing_tpu_torch.ops.geometry import recip_box_vectors

from torch_pair_cases import (PAIR_CASES, half_box_arrays,
                              pair_case_arrays, pair_case_slots)
from torch_spread_cases import (EXTRACT_LAYOUTS, FOLD_LAYOUTS, SPREAD_CASES,
                                WINDOW_INTERP_CASES, fold_windows,
                                layout_grids, potential_grids,
                                potential_windows, spread_case_slots,
                                window_bricks)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 machine)")
    return torch.device("cuda")


def _water(n_mol=512, seed=3, method=nbt.SlicedNonbondedForce.PME):
    """Rigid-water lattice through the port's API (3 cells per axis)."""
    rng = np.random.default_rng(seed)
    n_atoms = 3 * n_mol
    box = float(np.cbrt(n_atoms / 100.2))
    system = nbt.System()
    system.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0), (0, 0, box))
    force = nbt.SlicedNonbondedForce(3)
    force.setNonbondedMethod(method)
    force.setCutoffDistance(0.75)
    m = int(round(n_mol ** (1 / 3)))
    sp = box / m
    positions = np.zeros((n_atoms, 3))
    for k in range(n_mol):
        iz, r = divmod(k, m * m)
        iy, ix = divmod(r, m)
        c = (np.array([ix, iy, iz]) + 0.5) * sp + rng.uniform(-0.1, 0.1, 3)
        o = 3 * k
        positions[o] = c
        positions[o + 1] = c + [0.0957, 0.0, 0.0]
        positions[o + 2] = c + [-0.024, 0.0927, 0.0]
        for a, (q, s, e) in enumerate(((-0.834, 0.3151, 0.6364),
                                       (0.417, 0.04, 0.192),
                                       (0.417, 0.04, 0.192))):
            system.addParticle(15.999 if a == 0 else 1.008)
            force.addParticle(q, s, e)
            force.setParticleSubset(o + a, k % 3)
        for a, b in ((o, o + 1), (o, o + 2), (o + 1, o + 2)):
            force.addException(a, b, 0, 1, 0)
    force.addGlobalParameter("lam01", 0.7)
    force.addScalingParameter("lam01", 0, 1, True, True)
    system.addForce(force)
    return tplan.build_plan(force, system), positions


def _state(plan, positions, dev, switch=False):
    prep, app, cfg = tfused.make_fused_engine(plan, energies=True)
    data = tengine.plan_data(plan, device=dev, dtype=torch.float32)
    pos = torch.as_tensor(positions, device=dev).float()
    box = torch.as_tensor(np.asarray(plan.box0), device=dev).float()
    gvals = torch.tensor([0.7], device=dev)
    st = prep(pos, box, gvals, data)
    g, C = cfg["pair"].n_cells, cfg["pair"].capacity
    slot_pos = (torch.cat([st["pos0w"], pos.new_zeros((1, 3))])[st["slots"]]
                .reshape(g, C, 3).transpose(1, 2) + st["padfix3"]).contiguous()
    spread_kw = {key: dict(lattice=cfg["counts"],
                           radius=cuda_pme.spread_radius(
                               cfg[key], cfg["counts"], cfg["skin"],
                               plan.box0))
                 for key in ("pme_grid", "dispersion_grid") if key in cfg}
    return dict(prep=prep, app=app, cfg=cfg, data=data, pos=pos, box=box,
                gvals=gvals, st=st, slot_pos=slot_pos, spread_kw=spread_kw)


@pytest.mark.parametrize("energies", [False, True])
@pytest.mark.parametrize("mode", ["ewald", "reaction_field"])
def test_pair_kernel_matches_plain(cuda, mode, energies):
    import dataclasses
    plan, positions = _water()
    s = _state(plan, positions, cuda)
    cfg = s["cfg"]["pair"]
    if mode == "reaction_field":
        cfg = dataclasses.replace(cfg, mode=cuda_direct.MODE_REACTION_FIELD,
                                  krf=0.5, crf=1.6)
    st = s["st"]
    lam = torch.tensor([[1.0, 0.7, 1.0], [0.7, 1.0, 1.0], [1.0, 1.0, 1.0]],
                       device=cuda)
    args = (s["slot_pos"], st["slot_par"], st["slot_sub"], st["table"],
            st["sexcl"], lam, lam * 0.9, s["box"], cfg, energies,
            plan.num_particles)
    before = dict(cuda_direct.LAUNCHES)
    f_k, m_k = cuda_direct.pair_column(*args)
    f_p, m_p = cuda_direct.pair_column_plain(*args)
    torch.cuda.synchronize()
    key = "pair_column_energies" if energies else "pair_column"
    assert cuda_direct.LAUNCHES[key] == before[key] + 1
    scale = float(f_p.abs().max()) + 1.0
    assert float((f_k - f_p).abs().max()) <= 2e-5 * scale
    if energies:
        mk = m_k.double().sum(0)
        mp = m_p.double().sum(0)
        assert float((mk - mp).abs().max()) <= 1e-5 * (float(mp.abs().max())
                                                         + 1.0)
    # bitwise repeatable: no atomics in the pair kernel
    f_k2, _ = cuda_direct.pair_column(*args)
    assert torch.equal(f_k, f_k2)


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_pair_column_ranges_equal_whole_grid(cuda, case, parts):
    """pair_column launched over ``parts`` ranges of home cells (as the slab
    step of that many ranks launches it, K4): each range against the plain
    twin over it, the outputs concatenated equal to the whole-grid launch
    to the bit, forces and moment panels, each launch counted."""
    arrays = pair_case_arrays(case)
    args = pair_case_slots(arrays, False, cuda, torch.float32)["args"]
    cfg, n = arrays["cfg"], arrays["charge"].shape[0]
    key = "pair_column" + ("_ljpme" if cfg.ljpme else "") + "_energies"
    f_all, m_all = cuda_direct.pair_column(*args, True, n)
    per = -(-cfg.n_cells // parts)
    ranges = [(lo, min(per, cfg.n_cells - lo))
              for lo in range(0, cfg.n_cells, per)]
    before = cuda_direct.LAUNCHES[key]
    outs = [cuda_direct.pair_column(*args, True, n, cells=c) for c in ranges]
    torch.cuda.synchronize()
    assert cuda_direct.LAUNCHES[key] == before + len(outs)
    assert torch.equal(torch.cat([o[0] for o in outs]), f_all)
    assert torch.equal(torch.cat([o[1] for o in outs]), m_all)
    for c, (f_k, m_k) in zip(ranges, outs):
        f_p, m_p = cuda_direct.pair_column_plain(*args, True, n, cells=c)
        assert float((f_k - f_p).abs().max()) <= 2e-5 * (
            float(f_p.abs().max()) + 1.0)
        mk, mp = m_k.double().sum(0), m_p.double().sum(0)
        assert float((mk - mp).abs().max()) <= 1e-5 * (
            float(mp.abs().max()) + 1.0)
    f_only = cuda_direct.pair_column(*args, False, n, cells=ranges[-1])[0]
    assert torch.equal(f_only, cuda_direct.pair_column(*args, False, n)[0][
        ranges[-1][0]:])


def _solute(n_mol=1000):
    """The lattice of ``_water`` with port_systems.py's 12-site chain carved
    into its centre: its exclusions are not water triangles, so the fused
    engine takes the min-image cell kernel."""
    from port_systems import build_solute_system
    plan_w, positions = _water(n_mol)
    box = float(plan_w.box0[0, 0])
    system, force, pos, *_ = build_solute_system(nbt, positions, box)
    return tplan.build_plan(force, system), pos


@pytest.mark.parametrize("energies", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
def test_pair_cell_kernel_matches_plain(cuda, periodic, energies):
    import dataclasses
    plan, positions = _solute()
    prep, _, cfg = tfused.make_fused_engine(plan, energies=True)
    pc = dataclasses.replace(cfg["pair"], exceptions_periodic=periodic)
    data = tengine.plan_data(plan, device=cuda, dtype=torch.float32)
    pos = torch.as_tensor(positions, device=cuda).float()
    box = torch.as_tensor(np.asarray(plan.box0), device=cuda).float()
    gvals = torch.tensor([0.5, 0.8], device=cuda)
    st = prep(pos, box, gvals, data)
    g, C = pc.n_cells, pc.capacity
    slot_pos = (torch.cat([pos, pos.new_zeros((1, 3))])[st["slots"]]
                .reshape(g, C, 3).transpose(1, 2) + st["padfix3"]).contiguous()
    lam = torch.tensor([[1.0, 0.5], [0.5, 1.0]], device=cuda)
    args = (slot_pos, st["slot_par"], st["slot_sub"], st["table"],
            st["sexcl"], lam, lam * 1.6, box, pc, energies,
            plan.num_particles)
    before = dict(cuda_direct.LAUNCHES)
    f_k, m_k = cuda_direct.pair_cell(*args)
    f_p, m_p = cuda_direct.pair_cell_plain(*args)
    torch.cuda.synchronize()
    key = "pair_cell_energies" if energies else "pair_cell"
    assert cuda_direct.LAUNCHES[key] == before[key] + 1
    assert float((f_k - f_p).abs().max()) <= 2e-5 * (float(f_p.abs().max())
                                                     + 1.0)
    if energies:
        mk = m_k.double().sum(0)
        mp = m_p.double().sum(0)
        assert float((mk - mp).abs().max()) <= 1e-5 * (float(mp.abs().max())
                                                         + 1.0)
    # bitwise repeatable: no atomics in the pair kernel
    f_k2, _ = cuda_direct.pair_cell(*args)
    assert torch.equal(f_k, f_k2)


def _pair_kernel_against_twin(arrays, cell_kernel, dev):
    """Forces within 2e-5 * (max|F| + 1) of the plain twin's, moments within
    1e-5 * (max + 1) after the float64 sum, and two launches equal to the
    bit, force-only and with energies."""
    n = arrays["charge"].shape[0]
    args = pair_case_slots(arrays, cell_kernel, dev, torch.float32)["args"]
    kernel, plain, name = (
        (cuda_direct.pair_cell, cuda_direct.pair_cell_plain, "pair_cell")
        if cell_kernel else
        (cuda_direct.pair_column, cuda_direct.pair_column_plain,
         "pair_column"))
    for energies in (False, True):
        key = (name + ("_ljpme" if arrays["cfg"].ljpme else "")
               + ("_energies" if energies else ""))
        before = cuda_direct.LAUNCHES[key]
        f_k, m_k = kernel(*args, energies, n)
        f_k2, m_k2 = kernel(*args, energies, n)
        f_p, m_p = plain(*args, energies, n)
        torch.cuda.synchronize()
        assert cuda_direct.LAUNCHES[key] == before + 2
        assert float(f_p.abs().max()) > 1.0
        assert float((f_k - f_p).abs().max()) <= 2e-5 * (
            float(f_p.abs().max()) + 1.0)
        assert torch.equal(f_k, f_k2)
        if energies:
            shape = cuda_direct.pair_launch_shape(arrays["cfg"], cell_kernel,
                                                  True)
            assert m_k.shape[0] == shape["blocks"]
            mk, mp = m_k.double().sum(0), m_p.double().sum(0)
            assert float((mk - mp).abs().max()) <= 1e-5 * (
                float(mp.abs().max()) + 1.0)
            assert torch.equal(m_k, m_k2)
        else:
            assert m_k is None


@pytest.mark.parametrize("cell_kernel", [False, True],
                         ids=["pair_column", "pair_cell"])
@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_pair_kernels_hard_shapes_match_plain(cuda, case, cell_kernel):
    _pair_kernel_against_twin(pair_case_arrays(case), cell_kernel, cuda)


def test_pair_cell_kernel_at_half_a_box_length(cuda):
    """Pairs at half a box length along one axis, where the kernel's cheap
    minimum image of phase 1 and the exact one may differ."""
    _pair_kernel_against_twin(half_box_arrays(), True, cuda)


def test_pair_kernels_tile_the_largest_capacity(cuda):
    """1024 slots a cell (the limit) are staged a few cells at a time."""
    shape = cuda_direct.pair_launch_shape(
        cuda_direct.PairConfig(counts=(3, 3, 3), capacity=1024, nsub=8,
                               emax=16, mode=cuda_direct.MODE_EWALD,
                               cutoff=0.75), True, True)
    assert 1 <= shape["tile_cells"] < 27
    assert shape["shared_bytes"] <= 227 * 1024
    big = pair_case_arrays("large_capacity")
    assert cuda_direct.pair_launch_shape(big["cfg"], True, True)[
        "tile_cells"] < 27


def test_pme_kernels_match_plain(cuda):
    plan, positions = _water()
    s = _state(plan, positions, cuda)
    st = s["st"]
    grid_shape = s["cfg"]["pme_grid"]
    recip = recip_box_vectors(s["box"])
    kw = s["spread_kw"]["pme_grid"]
    grid_k = cuda_pme.pme_spread(s["slot_pos"], st["slot_q"], st["slot_sub"],
                                 recip, grid_shape, plan.num_subsets, **kw)
    grid_p = cuda_pme.pme_spread_plain(s["slot_pos"], st["slot_q"],
                                       st["slot_sub"], recip, grid_shape,
                                       plan.num_subsets)
    torch.cuda.synchronize()
    assert float((grid_k - grid_p).abs().max()) <= 2e-5 * float(
        grid_p.abs().max())
    # fixed-point sums: the spread grid is bitwise repeatable
    grid_k2 = cuda_pme.pme_spread(s["slot_pos"], st["slot_q"],
                                  st["slot_sub"], recip, grid_shape,
                                  plan.num_subsets, **kw)
    assert torch.equal(grid_k, grid_k2)
    # the double variant of energy evaluations: exact but for the 2^-40
    # fixed-point steps of its adds
    recip64 = recip_box_vectors(s["box"].double())
    before = dict(cuda_pme.LAUNCHES)
    grid_k64 = cuda_pme.pme_spread(s["slot_pos"], st["slot_q"],
                                   st["slot_sub"], recip64, grid_shape,
                                   plan.num_subsets, double=True, **kw)
    grid_p64 = cuda_pme.pme_spread_plain(s["slot_pos"], st["slot_q"],
                                         st["slot_sub"], recip64, grid_shape,
                                         plan.num_subsets, double=True)
    torch.cuda.synchronize()
    assert cuda_pme.LAUNCHES["pme_spread_energies"] == (
        before["pme_spread_energies"] + 1)
    assert grid_k64.dtype == torch.float64
    assert float((grid_k64 - grid_p64).abs().max()) <= 1e-7 * float(
        grid_p64.abs().max())

    eterm = torch.as_tensor(tpme.coulomb_eterm_np(
        grid_shape, s["cfg"]["pme_moduli"], plan.box0, plan.ewald_alpha),
        device=cuda).float()
    phi = torch.fft.irfftn(torch.fft.rfftn(grid_k, dim=(1, 2, 3)) * eterm,
                           s=tuple(grid_shape), dim=(1, 2, 3),
                           norm="forward").contiguous()
    f_k = cuda_pme.pme_interp(phi, s["slot_pos"], st["slot_q"],
                              st["slot_sub"], recip)
    f_p = cuda_pme.pme_interp_plain(phi, s["slot_pos"], st["slot_q"],
                                    st["slot_sub"], recip)
    torch.cuda.synchronize()
    assert float((f_k - f_p).abs().max()) <= 2e-5 * (float(f_p.abs().max())
                                                     + 1.0)


def test_pme_kernels_dispersion_pass_match_plain(cuda):
    """LJPME's second pass through B2 (float and double) and B3: per-slot
    C6 weights on the dispersion grid, against the twins, each launch
    counted under its dispersion name."""
    plan, positions = _water(method=nbt.SlicedNonbondedForce.LJPME)
    s = _state(plan, positions, cuda)
    st, cfg = s["st"], s["cfg"]
    grid_shape = cfg["dispersion_grid"]
    nsub = plan.num_subsets
    c6 = st["slot_c6"]
    assert float(c6.max()) > 0.01
    recip = recip_box_vectors(s["box"])
    before = dict(cuda_pme.LAUNCHES)
    args = (s["slot_pos"], c6, st["slot_sub"], recip, grid_shape, nsub)
    kw = s["spread_kw"]["dispersion_grid"]
    grid_k = cuda_pme.pme_spread(*args, dispersion=True, **kw)
    grid_p = cuda_pme.pme_spread_plain(*args)
    args64 = (s["slot_pos"], c6, st["slot_sub"],
              recip_box_vectors(s["box"].double()), grid_shape, nsub)
    grid_k64 = cuda_pme.pme_spread(*args64, double=True, dispersion=True,
                                   **kw)
    grid_p64 = cuda_pme.pme_spread_plain(*args64, double=True)
    eterm = torch.as_tensor(tpme.dispersion_eterm_np(
        grid_shape, cfg["dpme_moduli"], plan.box0, plan.dispersion_alpha),
        device=cuda).float()
    phi = torch.fft.irfftn(torch.fft.rfftn(grid_k, dim=(1, 2, 3)) * eterm,
                           s=tuple(grid_shape), dim=(1, 2, 3),
                           norm="forward").contiguous()
    f_k = cuda_pme.pme_interp(phi, s["slot_pos"], c6, st["slot_sub"], recip,
                              dispersion=True)
    f_p = cuda_pme.pme_interp_plain(phi, s["slot_pos"], c6, st["slot_sub"],
                                    recip)
    torch.cuda.synchronize()
    assert float((grid_k - grid_p).abs().max()) <= 2e-5 * float(
        grid_p.abs().max())
    assert float((grid_k64 - grid_p64).abs().max()) <= 1e-7 * float(
        grid_p64.abs().max())
    assert float(f_p.abs().max()) > 0.0
    assert float((f_k - f_p).abs().max()) <= 2e-5 * (float(f_p.abs().max())
                                                     + 1.0)
    made = {k: cuda_pme.LAUNCHES[k] - before[k] for k in before}
    assert made == {k: int(k in ("pme_spread_dispersion",
                                 "pme_spread_dispersion_energies",
                                 "pme_interp_dispersion")) for k in before}


def _spread_case_on_card(case, dev, bricks=None):
    """A case of tests/torch_spread_cases.py as the kernels take it: float32
    slot tensors on the card."""
    s = spread_case_slots(case, bricks=bricks)
    return dict(s, pos=s["pos"].float().to(dev), q=s["q"].float().to(dev),
                sub=s["sub"].to(dev),
                box=torch.as_tensor(s["box"], device=dev))


@pytest.mark.parametrize("case", sorted(SPREAD_CASES))
def test_spread_kernel_hard_shapes_match_plain(cuda, case):
    """B2 at the hard shapes of its owner decomposition (cubic, 28 points on
    6 groups, triclinic, atoms drifted half the skin towards every face,
    brick-major groups): charges and C6-like weights (0.05 |q|), float and
    double, against the twin (2e-5 of the grid's max; 1e-7 in double), and
    bitwise repeatable over two launches."""
    s = _spread_case_on_card(case, cuda)
    kw = dict(lattice=s["lattice"], radius=cuda_pme.spread_radius(
        s["grid"], s["lattice"], s["skin"], s["box"].cpu()))
    for weight in (s["q"], 0.05 * s["q"].abs()):
        for double, tol in ((False, 2e-5), (True, 1e-7)):
            recip = recip_box_vectors(s["box"].to(
                torch.float64 if double else torch.float32))
            args = (s["pos"], weight, s["sub"], recip, s["grid"], s["nsub"])
            grid_k = cuda_pme.pme_spread(*args, double=double, **kw)
            grid_p = cuda_pme.pme_spread_plain(*args, double=double)
            again = cuda_pme.pme_spread(*args, double=double, **kw)
            torch.cuda.synchronize()
            assert grid_k.dtype == grid_p.dtype
            assert float((grid_k - grid_p).abs().max()) <= tol * float(
                grid_p.abs().max())
            assert torch.equal(grid_k, again)


@pytest.mark.parametrize("case", sorted(SPREAD_CASES))
def test_window_spread_hard_shapes_match_plain(cuda, case):
    """The window spread at the same shapes, its slots on bricks of the
    case's cells: within 2e-5 of the windows' max of the twin, bitwise
    repeatable over two launches."""
    bricks = window_bricks(case)
    s = _spread_case_on_card(case, cuda, bricks=bricks)
    args = (s["pos"], s["q"], s["sub"], recip_box_vectors(s["box"].float()),
            s["grid"], bricks, s["nsub"])
    W_k = cuda_pme.pme_spread_windows(*args)
    W_p = cuda_pme.pme_spread_windows_plain(*args)
    again = cuda_pme.pme_spread_windows(*args)
    torch.cuda.synchronize()
    assert float((W_k - W_p).abs().max()) <= 2e-5 * float(W_p.abs().max())
    assert torch.equal(W_k, again)


def test_spread_is_one_launch_without_an_accumulator(cuda):
    """One spread, float or double: one call counted, one kernel on the card
    (no zeroing, no conversion pass) and one allocation, its grid's (no
    int64 accumulator)."""
    s = _spread_case_on_card("cubic", cuda)
    kw = dict(lattice=s["lattice"], radius=cuda_pme.spread_radius(
        s["grid"], s["lattice"], s["skin"], s["box"].cpu()))
    for double in (False, True):
        recip = recip_box_vectors(s["box"].to(
            torch.float64 if double else torch.float32))
        args = (s["pos"], s["q"], s["sub"], recip, s["grid"], s["nsub"])
        cuda_pme.pme_spread(*args, double=double, **kw)   # the build
        torch.cuda.synchronize()
        before = dict(cuda_pme.LAUNCHES)
        stats = torch.cuda.memory_stats()
        grid = cuda_pme.pme_spread(*args, double=double, **kw)
        after = torch.cuda.memory_stats()
        name = "pme_spread" + ("_energies" if double else "")
        assert {k: cuda_pme.LAUNCHES[k] - before[k] for k in before} == {
            k: int(k == name) for k in before}
        assert (after["allocation.all.allocated"]
                - stats["allocation.all.allocated"]) == 1
        assert (after["allocated_bytes.all.allocated"]
                - stats["allocated_bytes.all.allocated"]) < (
            grid.numel() * grid.element_size() + 1024)
        kernels = _card_kernels(
            lambda: cuda_pme.pme_spread(*args, double=double, **kw))
        assert len(kernels) == 1 and "spread_owner_kernel" in kernels[0], (
            kernels)


@pytest.mark.parametrize("case", sorted(SPREAD_CASES))
def test_interp_kernel_hard_shapes_match_plain(cuda, case):
    """B3 at the spread cases' shapes (drift across every face and the box
    face, triclinic, grids of 28 points, brick-major slots): charges and
    C6-like weights (0.05 |q|) on random potential grids against the twin
    within 2e-5 of (max|F| + 1), two launches equal to the bit."""
    s = _spread_case_on_card(case, cuda)
    phi = potential_grids(s).float().to(cuda)
    recip = recip_box_vectors(s["box"].float())
    for weight in (s["q"], 0.05 * s["q"].abs()):
        args = (phi, s["pos"], weight, s["sub"], recip)
        f_k = cuda_pme.pme_interp(*args)
        f_p = cuda_pme.pme_interp_plain(*args)
        again = cuda_pme.pme_interp(*args)
        torch.cuda.synchronize()
        assert float(f_p.abs().max()) > 0.0
        assert float((f_k - f_p).abs().max()) <= 2e-5 * (
            float(f_p.abs().max()) + 1.0)
        assert torch.equal(f_k, again)


@pytest.mark.parametrize("layout", sorted(FOLD_LAYOUTS))
def test_fold_kernel_layouts_equal_plain(cuda, layout):
    """The fold at layouts whose p differs per axis and reaches w = 2p, one
    brick along z, nsub 1 to 3: the twin's grid to the bit, twice."""
    W = fold_windows(layout).to(cuda)
    grid = cuda_pme.pme_fold(W)
    assert torch.equal(grid, cuda_pme.pme_fold_plain(W))
    assert torch.equal(grid, cuda_pme.pme_fold(W))


def _card_kernels(fn):
    """The names of the kernels the card ran in one call of ``fn``, from a
    profiler trace.  The profiler has once returned no device event at all
    for a call whose launch was counted: a trace without one says nothing
    of the launches, so the call is then profiled once more."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [ev.name for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    return kernels


def _one_launch(fn, name, kernel_name):
    """One call of ``fn``: one launch counted under ``name``, one kernel on
    the card (``kernel_name`` in its name, from a profiler trace; a trace
    with no device event is taken again, once) and one allocation, the
    output's."""
    fn()                                       # the build
    torch.cuda.synchronize()
    before = dict(cuda_pme.LAUNCHES)
    stats = torch.cuda.memory_stats()
    out = fn()
    after = torch.cuda.memory_stats()
    assert {k: cuda_pme.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == name) for k in before}
    assert (after["allocation.all.allocated"]
            - stats["allocation.all.allocated"]) == 1
    assert (after["allocated_bytes.all.allocated"]
            - stats["allocated_bytes.all.allocated"]) < (
        out.numel() * out.element_size() + 1024)
    kernels = _card_kernels(fn)
    assert len(kernels) == 1 and kernel_name in kernels[0], kernels


def test_interp_and_fold_are_one_launch(cuda):
    s = _spread_case_on_card("cubic", cuda)
    phi = potential_grids(s).float().to(cuda)
    args = (phi, s["pos"], s["q"], s["sub"],
            recip_box_vectors(s["box"].float()))
    _one_launch(lambda: cuda_pme.pme_interp(*args), "pme_interp",
                "interp_kernel")
    W = fold_windows("uneven").to(cuda)
    _one_launch(lambda: cuda_pme.pme_fold(W), "pme_fold", "fold_kernel")


@pytest.mark.parametrize("layout", sorted(EXTRACT_LAYOUTS))
def test_extract_kernel_layouts_equal_plain(cuda, layout):
    """Extract at the fold's layouts (p differing per axis, w = 2p, one
    brick along z, nsub 1 to 3) and one of rows of 14 points, so 16-, 8- and
    4-byte stores: the twin's windows to the bit, twice, and from a grid one
    float off 16 bytes too."""
    bricks = EXTRACT_LAYOUTS[layout][0]
    grid = layout_grids(layout).to(cuda)
    W = cuda_pme.pme_extract(grid, bricks)
    assert torch.equal(W, cuda_pme.pme_extract_plain(grid, bricks))
    assert torch.equal(W, cuda_pme.pme_extract(grid, bricks))
    odd = torch.empty(grid.numel() + 1, device=cuda)[1:].view(grid.shape)
    odd.copy_(grid)
    assert torch.equal(cuda_pme.pme_extract(odd, bricks), W)


@pytest.mark.parametrize("case", WINDOW_INTERP_CASES)
def test_interp_windows_kernel_widths_match_plain(cuda, case):
    """The window interpolation at windows of 13, 14 and 16 points along z
    (float, float2 and float4 chunks), atoms drifted so far that rows reach
    past the window, and at brick-major spread cases (one brick along y and
    z in one): charges and C6-like weights (0.05 |q|) against the twin
    within 2e-5 of (max|F| + 1), two launches equal to the bit."""
    bricks = window_bricks(case)
    s = _spread_case_on_card(case, cuda, bricks=bricks)
    W = potential_windows(s, bricks).float().to(cuda)
    recip = recip_box_vectors(s["box"].float())
    for weight in (s["q"], 0.05 * s["q"].abs()):
        args = (W, s["pos"], weight, s["sub"], recip)
        f_k = cuda_pme.pme_interp_windows(*args)
        f_p = cuda_pme.pme_interp_windows_plain(*args)
        again = cuda_pme.pme_interp_windows(*args)
        torch.cuda.synchronize()
        assert float(f_p.abs().max()) > 0.0
        assert float((f_k - f_p).abs().max()) <= 2e-5 * (
            float(f_p.abs().max()) + 1.0)
        assert torch.equal(f_k, again)


def test_extract_and_interp_windows_are_one_launch(cuda):
    grid = layout_grids("w2p_all").to(cuda)
    bricks = EXTRACT_LAYOUTS["w2p_all"][0]
    _one_launch(lambda: cuda_pme.pme_extract(grid, bricks), "pme_extract",
                "extract_kernel")
    bricks = window_bricks("w16")
    s = _spread_case_on_card("w16", cuda, bricks=bricks)
    args = (potential_windows(s, bricks).float().to(cuda), s["pos"], s["q"],
            s["sub"], recip_box_vectors(s["box"].float()))
    _one_launch(lambda: cuda_pme.pme_interp_windows(*args),
                "pme_interp_windows", "interp_windows_kernel")


@pytest.mark.parametrize("method", ["PME", "LJPME"])
def test_fused_engine_on_card_matches_cpu_f64(cuda, method):
    plan, positions = _water(method=getattr(nbt.SlicedNonbondedForce, method))
    s = _state(plan, positions, cuda)
    e_g, f_g, _ = s["app"](s["pos"], s["box"], s["gvals"], s["data"], s["st"])
    prep, app, _ = tfused.make_fused_engine(plan, energies=True)
    data = tengine.plan_data(plan, device="cpu", dtype=torch.float64)
    pos = torch.as_tensor(positions)
    box = torch.as_tensor(np.asarray(plan.box0))
    gvals = torch.tensor([0.7], dtype=torch.float64)
    e_c, f_c, _ = app(pos, box, gvals, data, prep(pos, box, gvals, data))
    lam = torch.tensor([0.7], dtype=torch.float64)
    from nonbondedslicing_tpu_torch.ops.params import slice_lambdas
    lam_s = slice_lambdas(plan.lam_source, lam)
    E_g = float(tengine.contract_energy(e_g.cpu(), lam_s))
    E_c = float(tengine.contract_energy(e_c, lam_s))
    assert abs(E_g - E_c) <= 1e-5 * abs(E_c)
    f_c_max = float(f_c.abs().max())
    assert float((f_g.cpu().double() - f_c).abs().max()) <= 5e-5 * f_c_max


@pytest.mark.parametrize("method", ["PME", "CutoffPeriodic"])
def test_make_compute_kernel_route_on_card(cuda, method):
    """The generic engine's kernel route (pair_cell on a slot table built
    per call, Ewald or reaction-field mode) in float32 on the card against
    the same make_compute in float64 on the card (the plain cell list and
    the generic exclusion corrections): total energy 1e-5 relative, forces
    5e-5 of max|F|.  Under the reaction field the force jumps at the
    cutoff, so atoms with a pair within 1e-6 nm of it are left out of the
    force check."""
    from nonbondedslicing_tpu_torch.ops.params import slice_lambdas
    plan, positions = _water(method=getattr(nbt.SlicedNonbondedForce, method))
    compute = tengine.make_compute(plan, True, True, with_aux=True)
    assert compute.route == "pallas"
    out = {}
    for dtype in (torch.float32, torch.float64):
        before = dict(cuda_direct.LAUNCHES)
        out[dtype] = compute(
            torch.as_tensor(positions, device=cuda).to(dtype),
            torch.as_tensor(np.asarray(plan.box0), device=cuda).to(dtype),
            torch.tensor([0.7], device=cuda, dtype=dtype),
            tengine.plan_data(plan, device=cuda, dtype=dtype))
        made = {k: v - before[k] for k, v in cuda_direct.LAUNCHES.items()
                if v != before[k]}
        assert made == ({"pair_cell_energies": 1} if dtype == torch.float32
                        else {})
    (e_g, f_g, aux), (e_c, f_c, _) = out[torch.float32], out[torch.float64]
    assert int(aux["overflow"]) == 0 and float(aux["excl_span"]) < 1.0
    lam_s = slice_lambdas(plan.lam_source,
                          torch.tensor([0.7], dtype=torch.float64))
    E_g = float(tengine.contract_energy(e_g.cpu(), lam_s))
    E_c = float(tengine.contract_energy(e_c.cpu(), lam_s))
    assert abs(E_g - E_c) <= 1e-5 * abs(E_c)
    keep = np.ones(len(positions), dtype=bool)
    if method == "CutoffPeriodic":
        box = np.diag(plan.box0)
        d = positions[:, None] - positions[None]
        d -= box * np.round(d / box)
        near = np.abs(np.linalg.norm(d, axis=-1) - plan.cutoff) < 1e-6
        keep = ~near.any(axis=1)
    err = (f_g.double() - f_c).abs().max(dim=1).values.cpu().numpy()
    assert err[keep].max() <= 5e-5 * float(f_c.abs().max())


# ------------------------------------------------ the window PME pipeline

# (cells, bricks, grid, nsub, atoms, cell capacity): one cell per brick; 8
# cells per brick (f = 2: 640 slots a brick, more than one block's threads
# and than one staged chunk of the spread kernel); more subsets than one
# pass of the spread kernel holds in shared memory (w = 15: 15 subsets)
WINDOW_CASES = {
    "one_cell": ((3, 3, 3), (3, 3, 3), (27, 27, 27), 3, 2000, 128),
    "eight_cells": ((4, 4, 4), (2, 2, 2), (24, 24, 24), 2, 3000, 80),
    "two_passes": ((3, 3, 3), (3, 3, 3), (27, 27, 27), 17, 2000, 128),
}


def _window_slots(case, dev, seed=12):
    """Brick-major slot tensors of random charges in a 4.2 nm box, pad
    slots far outside it as the fused engine places them."""
    from nonbondedslicing_tpu_torch.ops import neighbors, pme_bricks
    cells, bricks, grid, nsub, n, capacity = WINDOW_CASES[case]
    rng = np.random.default_rng(seed)
    box = torch.eye(3, device=dev) * 4.2
    pos = torch.as_tensor(rng.random((n, 3)) * 4.2, device=dev).float()
    q = torch.as_tensor(rng.normal(size=n), device=dev).float()
    sub = torch.as_tensor(rng.integers(0, nsub, n), device=dev)
    table, ov = neighbors.build_occupancy(
        neighbors.cell_ids(pos, box, cells), n, cells, capacity)
    assert int(ov) == 0
    slots = table.reshape(-1).long()
    g = cells[0] * cells[1] * cells[2]
    pad = torch.where(slots == n, 5000.0 + 64.0 * torch.arange(
        slots.shape[0], device=dev), 0.0).reshape(g, 1, capacity)
    slot_pos = (torch.cat([pos, pos.new_zeros((1, 3))])[slots]
                .reshape(g, capacity, 3).transpose(1, 2) + pad)
    slot_q = torch.cat([q, q.new_zeros(1)])[slots].reshape(g, 1, capacity)
    slot_sub = torch.cat([sub, sub.new_zeros(1)])[slots].reshape(
        g, 1, capacity).to(torch.int32)
    to_b = lambda x: pme_bricks.cells_to_bricks(x, cells, bricks).contiguous()
    return dict(pos=to_b(slot_pos), q=to_b(slot_q)[:, 0].contiguous(),
                sub=to_b(slot_sub)[:, 0].contiguous(),
                recip=recip_box_vectors(box), bricks=bricks, grid=grid,
                nsub=nsub)


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_kernels_match_plain(cuda, case):
    s = _window_slots(case, cuda)
    args = (s["pos"], s["q"], s["sub"], s["recip"], s["grid"], s["bricks"],
            s["nsub"])
    before = dict(cuda_pme.LAUNCHES)
    W_k = cuda_pme.pme_spread_windows(*args)
    W_p = cuda_pme.pme_spread_windows_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(W_k).all()
    assert float((W_k - W_p).abs().max()) <= 2e-5 * float(W_p.abs().max())
    # fixed-point sums: bitwise repeatable
    assert torch.equal(W_k, cuda_pme.pme_spread_windows(*args))

    grid_k = cuda_pme.pme_fold(W_k)
    assert torch.equal(grid_k, cuda_pme.pme_fold_plain(W_k))
    # the two spread designs give the same grid, up to the shift
    grid_s = cuda_pme.pme_spread(
        s["pos"], s["q"], s["sub"], s["recip"], s["grid"], s["nsub"],
        lattice=s["bricks"], radius=cuda_pme.spread_radius(
            s["grid"], s["bricks"], 0.0, 4.2 * np.eye(3)))
    assert float((torch.roll(grid_k, (-1, -1, -1), (1, 2, 3)) - grid_s)
                 .abs().max()) <= 2e-5 * float(grid_s.abs().max())

    phi = torch.fft.irfftn(
        torch.fft.rfftn(grid_k, dim=(1, 2, 3)) * torch.exp(
            -0.1 * torch.arange(s["grid"][2] // 2 + 1, device=cuda) ** 2),
        s=s["grid"], dim=(1, 2, 3)).contiguous()
    W_phi = cuda_pme.pme_extract(phi, s["bricks"])
    assert torch.equal(W_phi, cuda_pme.pme_extract_plain(phi, s["bricks"]))
    f_args = (W_phi, s["pos"], s["q"], s["sub"], s["recip"])
    f_k = cuda_pme.pme_interp_windows(*f_args)
    f_p = cuda_pme.pme_interp_windows_plain(*f_args)
    torch.cuda.synchronize()
    assert float(f_p.abs().max()) > 0.0
    assert float((f_k - f_p).abs().max()) <= 2e-5 * (float(f_p.abs().max())
                                                     + 1.0)
    for name, n in (("pme_spread_windows", 2), ("pme_fold", 1),
                    ("pme_extract", 1), ("pme_interp_windows", 1)):
        assert cuda_pme.LAUNCHES[name] == before[name] + n


def test_window_kernels_drop_points_outside_the_window(cuda):
    """Atoms moved 2.5 grid spacings after the slot table was built: the
    kernels drop the same stencil points as their twins."""
    s = _window_slots("one_cell", cuda)
    pos = (s["pos"] + 2.5 * 4.2 / 27).contiguous()
    args = (pos, s["q"], s["sub"], s["recip"], s["grid"], s["bricks"],
            s["nsub"])
    W_k = cuda_pme.pme_spread_windows(*args)
    W_p = cuda_pme.pme_spread_windows_plain(*args)
    assert abs(float(W_p.sum()) - float(s["q"].sum())) > 1e-2
    assert float((W_k - W_p).abs().max()) <= 2e-5 * float(W_p.abs().max())
    W_phi = torch.randn_like(W_k)
    f_k = cuda_pme.pme_interp_windows(W_phi, pos, s["q"], s["sub"],
                                      s["recip"])
    f_p = cuda_pme.pme_interp_windows_plain(W_phi, pos, s["q"], s["sub"],
                                            s["recip"])
    assert float((f_k - f_p).abs().max()) <= 2e-5 * (float(f_p.abs().max())
                                                     + 1.0)


def test_window_kernels_refuse_wide_windows(cuda):
    """w > 2p raises on CUDA tensors as on CPU tensors; nothing falls back."""
    with pytest.raises(ValueError, match="stencil"):
        cuda_pme.pme_fold(torch.zeros((2, 2, 2, 2, 10, 10, 10), device=cuda))
    with pytest.raises(ValueError, match="stencil"):
        cuda_pme.pme_extract(torch.zeros((2, 8, 8, 8), device=cuda),
                             (2, 2, 2))


def test_grid_pipeline_on_card_matches_stencil_pipeline(cuda):
    """The fused engine through the window pipeline on the card: forces
    within 2e-5 * (max|F| + 1) of the default pipeline's, the same slice
    energies (both from the double whole-grid spread), bitwise repeatable."""
    plan, positions = _water()
    out = {}
    for pipeline in ("stencil", "grid"):
        prep, app, _ = tfused.make_fused_engine(plan, energies=True,
                                                pme_pipeline=pipeline)
        data = tengine.plan_data(plan, device=cuda, dtype=torch.float32)
        pos = torch.as_tensor(positions, device=cuda).float()
        box = torch.as_tensor(np.asarray(plan.box0), device=cuda).float()
        gvals = torch.tensor([0.7], device=cuda)
        st = prep(pos, box, gvals, data)
        out[pipeline] = app(pos, box, gvals, data, st)
        if pipeline == "grid":
            again = app(pos, box, gvals, data, st)
            assert torch.equal(again[1], out["grid"][1])
    (e_s, f_s, _), (e_g, f_g, _) = out["stencil"], out["grid"]
    assert torch.equal(e_s, e_g)
    assert float((f_g - f_s).abs().max()) <= 2e-5 * (float(f_s.abs().max())
                                                     + 1.0)
