"""The sharded evaluation's kernel on the card: ``pair_cell`` over cell
ranges, and ``make_sharded_compute`` in two ranks on one card over gloo.

Marked ``gpu``; they skip (from inside the fixture) where no CUDA device is
present.  On a machine with an H100:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_parallel.py
"""

import numpy as np
import pytest
import torch

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import cuda_direct
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.ops.params import slice_lambdas

from torch_pair_cases import PAIR_CASES, pair_case_arrays, pair_case_slots
import torch_parallel_cases

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 machine)")
    return torch.device("cuda")


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_pair_cell_ranges_equal_whole_grid(cuda, case, parts):
    """pair_cell launched over ``parts`` ranges of cells (as a sharded
    evaluation of that many ranks launches it): the outputs concatenated
    equal the whole-grid launch to the bit, forces and moment panels, and
    each launch is counted."""
    arrays = pair_case_arrays(case)
    args = pair_case_slots(arrays, True, cuda, torch.float32)["args"]
    cfg, n = arrays["cfg"], arrays["charge"].shape[0]
    key = "pair_cell" + ("_ljpme" if cfg.ljpme else "") + "_energies"
    f_all, m_all = cuda_direct.pair_cell(*args, True, n)
    per = -(-cfg.n_cells // parts)
    before = cuda_direct.LAUNCHES[key]
    outs = [cuda_direct.pair_cell(*args, True, n,
                                  cells=(lo, min(per, cfg.n_cells - lo)))
            for lo in range(0, cfg.n_cells, per)]
    torch.cuda.synchronize()
    assert cuda_direct.LAUNCHES[key] == before + len(outs)
    assert torch.equal(torch.cat([o[0] for o in outs]), f_all)
    assert torch.equal(torch.cat([o[1] for o in outs]), m_all)
    f_plain, _ = cuda_direct.pair_cell_plain(*args, True, n,
                                             cells=(0, per))
    assert float((outs[0][0] - f_plain).abs().max()) <= 2e-5 * (
        float(f_plain.abs().max()) + 1.0)


def test_sharded_compute_two_ranks_on_one_card(cuda, tmp_path):
    """make_sharded_compute in two ranks on this card over gloo (CUDA
    tensors) at a 2.8 nm cut of the benchmark's water (3 cells of the
    cutoff per axis, the kernel route, pair_cell over half the cells a
    rank) against make_compute on the card: every rank the same result,
    direct-space forces equal to the bit, forces within 1e-5 of max|F|,
    energy and dE/dlambda within 1e-6 relative (phase 14 (a)'s gates of
    chip_smoke.py)."""
    from port_systems import STATE_FILE, build_system, water_cube, \
        water_system
    blob = np.load(STATE_FILE)
    pos, _, edge = water_cube(blob["positions"], blob["velocities"],
                              build_system(nbt)[2], 2.8)
    system, force, _ = water_system(nbt, len(pos) // 3, edge)
    plan = tplan.build_plan(force, system)
    ranks = torch_parallel_cases.run_ranks(
        2, str(tmp_path), [("cube", "torch_parallel_cases:sharded_plan",
                            dict(plan=plan, positions=pos))],
        backend="gloo", devices=[str(cuda)] * 2)
    route, e, f, f_dir = ranks[0]["cube"]
    assert route == "pallas"
    for a, b in zip(ranks[0]["cube"][1:], ranks[1]["cube"][1:]):
        assert np.array_equal(a, b)
    args = [torch.as_tensor(np.asarray(x), device=cuda).float()
            for x in (pos, plan.box0, plan.global_defaults)]
    args.append(tengine.plan_data(plan, device=cuda, dtype=torch.float32))
    e1, f1 = (x.cpu() for x in tengine.make_compute(plan, True, True)(*args))
    f_dir1 = tengine.make_compute(plan, True, False)(*args)[1].cpu()
    assert torch.equal(torch.as_tensor(f_dir), f_dir1)
    assert float((torch.as_tensor(f) - f1).abs().max()) <= 1e-5 * float(
        f1.abs().max())
    lam = slice_lambdas(plan.lam_source,
                        torch.as_tensor(plan.global_defaults,
                                        dtype=torch.float64))
    e = torch.as_tensor(e)
    E, E1 = (float(tengine.contract_energy(x, lam)) for x in (e, e1))
    assert abs(E - E1) <= 1e-6 * abs(E1)
    d, d1 = (tengine.parameter_derivatives(x, plan.deriv_mask)
             for x in (e, e1))
    assert float(((d - d1).abs() / d1.abs().clamp(min=1.0)).max()) <= 1e-6


# nm after 20 steps of 2 fs between two runs of the same step whose
# forces differ by float32 rounding (an atom's pair, reciprocal and
# exclusion-row forces come from different ranks and are added by the
# all_reduce in another order, D10: within 1e-5 of max|F| ~ 4e3
# kJ/mol/nm, phase 14's gate, which move an atom of 1 amu by at most
# sum_k k dt^2 dF / m = 210 *
# 4e-6 * 0.04 = 3.4e-5 nm), and whose float32 constraint solves round
# inputs an ulp apart up to 8 ulps apart (1.9e-6 nm below 4 nm), each
# carried into every later step by the velocity: 210 * 1.9e-6 = 4.0e-4 nm
# (chip_smoke.py's TOL_SLAB_MD says more)
TOL_SLAB_MD = 4.3e-4
# steps a window: the JAX heuristic (8 nm/ps) gives 5 at this cube's 0.171
# nm skin, within which a hydrogen at 300 K can cover skin/2 (0.0868 nm
# was seen): the guard raises, correctly; 3 keeps it well inside
SLAB_K = 3


def _slab_cube(edge=3.3):
    """A cut of the benchmark's water at its density, 3 cells of cutoff +
    0.1 nm a axis, with SETTLE's triangles as constraints: (plan, positions,
    velocities, masses, constraints)."""
    from port_systems import (STATE_FILE, WATER_MASSES, build_system,
                              water_cube, water_system)
    blob = np.load(STATE_FILE)
    pos, vel, box = water_cube(blob["positions"], blob["velocities"],
                               build_system(nbt)[2], edge)
    system, force, constraints = water_system(nbt, len(pos) // 3, box)
    masses = np.tile(WATER_MASSES, len(pos) // 3)
    return (tplan.build_plan(force, system), pos, vel, masses,
            tuple(np.asarray(c) for c in constraints))


def test_slab_step_two_ranks_on_one_card(cuda, tmp_path):
    """make_sharded_md_step in two ranks on this card over gloo (eager
    windows): every rank the same state to the bit, pair_column launched
    over each rank's slab once a step and once for the energies, the
    positions after 20 steps within TOL_SLAB_MD of the same step in a
    1-rank group (the whole grid on one rank), and the energy of the
    starting state within 1e-6 of its (phase 14's gate: the same
    positions, the ranks' float64 pair and exclusion-row energies summed
    in another order; the PME grids are summed as integers)."""
    plan, pos, vel, masses, cons = _slab_cube()
    kw = dict(plan=plan, positions=pos, velocities=vel, masses=masses,
              constraints=cons, n_steps=20, reuse_steps=SLAB_K)
    ranks = torch_parallel_cases.run_ranks(
        2, str(tmp_path), [("slab", "torch_parallel_cases:slab_card", kw),
                           ("alone", "torch_parallel_cases:slab_card",
                            dict(kw, alone=True))],
        backend="gloo", devices=[str(cuda)] * 2)
    a, b = ranks[0]["slab"], ranks[1]["slab"]
    assert np.array_equal(a["pos"], b["pos"])
    assert np.array_equal(a["vel"], b["vel"]) and a["energy"] == b["energy"]
    config = a["config"]
    assert config["graph"] is False and config["pair"] == "pair_column"
    assert config["counts"] == (3, 3, 3) and config["devices"] == 2
    for r in ranks:
        assert r["slab"]["launches"] == {"pair_column": 20,
                                         "pair_column_energies": 1}
        assert r["alone"]["config"]["devices"] == 1
    one = ranks[0]["alone"]
    assert np.abs(a["pos"] - one["pos"]).max() <= TOL_SLAB_MD
    assert abs(a["energy_start"] - one["energy_start"]) <= 1e-6 * abs(
        one["energy_start"])


def test_slab_step_nccl_graphed(cuda, tmp_path):
    """One rank over NCCL: the windows replay CUDA graphs with the force
    all_reduce captured; two windows of the graph against two of the
    eager body from the same state equal to the bit (positions,
    velocities and energy: the atom-range PME's grids are int64 sums), no
    capture after the warm-up."""
    plan, pos, vel, masses, cons = _slab_cube()
    ranks = torch_parallel_cases.run_ranks(
        1, str(tmp_path), [("slab", "torch_parallel_cases:slab_card",
                            dict(plan=plan, positions=pos, velocities=vel,
                                 masses=masses, constraints=cons,
                                 n_steps=20, reuse_steps=SLAB_K))],
        backend="nccl", devices=[str(cuda)])
    out = ranks[0]["slab"]
    assert out["config"]["graph"] is True
    g = out["graph"]
    assert g["captures"][0] >= 1 and g["captures"][1] == g["captures"][0]
    assert np.array_equal(g["pos"][0], g["pos"][1])
    assert np.array_equal(g["vel"][0], g["vel"][1])
    assert g["energy"][0] == g["energy"][1]
