"""The MD step's CUDA graphs against its eager body, on the card.

``make_md_step`` runs every K-step window on CUDA tensors as a replay of a
captured CUDA graph; ``run.eager`` runs the same body without it.  On the
benchmark's rigid-water box (23,289 atoms, pair_column, SETTLE; under PME,
under LJPME and through pme_pipeline="grid") and on the solute box
(pair_cell, bonds, M-SHAKE; and with the chain's bonds as constraints,
one 11-wide cluster solved by CGLS) the two give positions and velocities
equal to the bit, and so are the energies (the exclusion rows' slice
energies are summed in a fixed order).
Marked ``gpu``; they skip (from inside the fixture) where no CUDA
device is present.  On a machine with an H100:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_graph.py
"""

import numpy as np
import pytest
import torch

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import cuda_direct, cuda_pme
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.runtime.fastpath import make_md_step

from nonbondedslicing_tpu_torch.runtime.constraints import \
    cluster_constraints

from port_systems import (DT_PS, N_MOLECULES, STATE_FILE, WATER_MASSES,
                          build_solute_system, build_system,
                          chain_constraints, solute_velocities)

pytestmark = pytest.mark.gpu

# cell capacity with room for the density fluctuations of a few hundred
# steps (profile_md.py's choice for the benchmark state)
CAPACITY = 144


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 machine)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def rigid(cuda):
    system, force, box_len, constraints = build_system(nbt)
    plan = tplan.build_plan(force, system)
    blob = np.load(STATE_FILE)
    return dict(plan=plan, constraints=constraints,
                masses=np.tile(WATER_MASSES, N_MOLECULES),
                pos=torch.as_tensor(blob["positions"], device=cuda).float(),
                vel=torch.as_tensor(blob["velocities"], device=cuda).float(),
                box=torch.as_tensor(np.diag([box_len] * 3), device=cuda
                                    ).float(),
                gvals=torch.ones(2, device=cuda),
                data=tengine.plan_data(plan, device=cuda,
                                       dtype=torch.float32))


def _launches():
    return dict(cuda_direct.LAUNCHES, **cuda_pme.LAUNCHES)


def _made(before):
    now = _launches()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def _rigid_run(rigid, **kw):
    return make_md_step(rigid["plan"], rigid["masses"], dt=DT_PS,
                        cell_capacity=CAPACITY,
                        constraints=rigid["constraints"], **kw)


def _args(s, pos=None, vel=None):
    return (s["pos"] if pos is None else pos, s["vel"] if vel is None
            else vel, s["box"], s["gvals"], s["data"])


def test_graph_equals_eager_rigid(rigid):
    """Two windows of K from the same state: the graph's replays against
    the eager body, positions and velocities to the bit, the same kernel
    launches counted."""
    run = _rigid_run(rigid)
    K = run.config["reuse_steps"]
    assert run.config["graph"]
    p, v, _ = run(*_args(rigid), K)          # the warm-up window, captured
    assert run.stats["captures"] == 1 and run.stats["replays"] == 0
    before = _launches()
    p_g, v_g, e_g = run(*_args(rigid, p, v), 2 * K)
    made_g = _made(before)
    assert run.stats["replays"] == 2 and run.stats["captures"] == 1
    before = _launches()
    p_e, v_e, e_e = run.eager(*_args(rigid, p, v), 2 * K)
    made_e = _made(before)
    assert made_g == made_e and made_g["pair_column"] == 2 * K
    assert torch.equal(p_g, p_e) and torch.equal(v_g, v_e)
    assert float(e_g) == float(e_e)


def _graph_equals_eager(run, s):
    """Two windows from the state one captured window reaches, replayed
    and through the eager body: positions and velocities to the bit, the
    same launches counted; returns the launches of the replays."""
    K = run.config["reuse_steps"]
    assert run.config["graph"]
    p, v, _ = run(*_args(s), K)
    before = _launches()
    p_g, v_g, e_g = run(*_args(s, p, v), 2 * K)
    made_g = _made(before)
    before = _launches()
    p_e, v_e, e_e = run.eager(*_args(s, p, v), 2 * K)
    assert made_g == _made(before) and run.stats["replays"] == 2
    assert torch.equal(p_g, p_e) and torch.equal(v_g, v_e)
    assert float(e_g) == float(e_e)
    return made_g


def test_graph_equals_eager_ljpme(rigid):
    """The rigid box under LJPME (the C6 pass of B2 and B3, B1's
    dispersion terms, the rows' back-out): the graph against the eager
    body to the bit."""
    system, force, _, _ = build_system(nbt, "LJPME")
    plan = tplan.build_plan(force, system)
    s = dict(rigid, plan=plan,
             data=tengine.plan_data(plan, device=rigid["pos"].device,
                                    dtype=torch.float32))
    made = _graph_equals_eager(_rigid_run(s), s)
    # one C6 spread per evaluation: every step and the final one
    assert made["pme_spread_dispersion"] == (
        made["pair_column_ljpme"] + made["pair_column_ljpme_energies"]) > 0


def test_graph_equals_eager_grid(rigid):
    """The rigid box through pme_pipeline="grid" (brick-major slots, the
    four window kernels): the graph against the eager body to the bit."""
    made = _graph_equals_eager(_rigid_run(rigid, pme_pipeline="grid"), rigid)
    # one fold per evaluation: every step and the final one
    assert made["pme_fold"] == (made["pair_column"]
                                + made["pair_column_energies"]) > 0


def test_graph_launch_counts_per_replay(rigid):
    """A capture counts nothing; each replay adds the kernels of one
    window, and a run of n windows counts what the eager body does."""
    run = _rigid_run(rigid, pme_pipeline="grid")
    K = run.config["reuse_steps"]
    before = _launches()
    run.eager(*_args(rigid), K)
    eager_one = _made(before)
    before = _launches()
    run(*_args(rigid), K)                    # eager window + capture
    assert _made(before) == eager_one
    before = _launches()
    run(*_args(rigid), 5 * K)
    made = _made(before)
    assert run.stats["replays"] == 5
    # five windows' kernels and one final evaluation with energies
    assert made["pme_fold"] == 5 * K + 1
    assert made["pair_column"] == 5 * K
    assert made["pair_column_energies"] == 1
    # made = 5 windows + one final evaluation, eager_one = 1 + 1
    assert 4 * run.stats["replayed_launches"] == 5 * (
        sum(made.values()) - sum(eager_one.values()))


def test_graph_recaptures_on_new_data_not_on_gvals(rigid, cuda):
    """A lambda sweep of three values replays one capture (gvals is copied
    into its buffer) and gives the eager body's energies; new ``data``
    tensors are captured anew, and only the newest graphs are kept."""
    run = _rigid_run(rigid)
    K = run.config["reuse_steps"]
    run(*_args(rigid), K)
    assert run.stats["captures"] == 1
    for lam in (1.0, 0.5, 0.0):
        gvals = torch.tensor([lam, 1.0 - 0.5 * lam], device=cuda)
        args = (rigid["pos"], rigid["vel"], rigid["box"], gvals,
                rigid["data"])
        p_g, _, e_g = run(*args, 2 * K)
        p_e, _, e_e = run.eager(*args, 2 * K)
        assert torch.equal(p_g, p_e)
        assert float(e_g) == float(e_e)
    assert run.stats["captures"] == 1 and run.stats["replays"] == 6
    data2 = tengine.plan_data(rigid["plan"], device=cuda,
                              dtype=torch.float32)
    p_g, _, _ = run(rigid["pos"], rigid["vel"], rigid["box"],
                    rigid["gvals"], data2, 2 * K)
    assert run.stats["captures"] == 2 and run.stats["replays"] == 7
    p_e, _, _ = run.eager(*_args(rigid), 2 * K)
    assert torch.equal(p_g, p_e)


def test_graph_mixed_precision(rigid):
    """mixed inside the graph: float64 positions, float32 velocities, to
    the bit against the eager body."""
    run = _rigid_run(rigid, mixed_precision=True)
    assert run.config["mixed_precision"] and run.config["graph"]
    K = run.config["reuse_steps"]
    p, v, _ = run(*_args(rigid), K)
    assert p.dtype == torch.float64 and v.dtype == torch.float32
    p_g, v_g, e_g = run(*_args(rigid, p, v), 2 * K)
    p_e, v_e, e_e = run.eager(*_args(rigid, p, v), 2 * K)
    assert run.stats["replays"] == 2
    assert torch.equal(p_g, p_e) and torch.equal(v_g, v_e)
    assert float(e_g) == float(e_e)


def _solute_graph_against_eager(cuda, constrained):
    """The solute box's graph against its eager body over two windows:
    positions and velocities to the bit, the same launches counted."""
    _, _, box_len, _ = build_system(nbt)
    blob = np.load(STATE_FILE)
    (system, force, pos_np, masses, constraints, bonds,
     kept) = build_solute_system(nbt, blob["positions"], box_len)
    if constrained:
        triples, bonds = chain_constraints(constraints, bonds)
        constraints = cluster_constraints(triples, len(masses))
        assert constraints[0].shape[1] == 11
    plan = tplan.build_plan(force, system)
    run = make_md_step(plan, masses, dt=DT_PS, cell_capacity=CAPACITY,
                       constraints=constraints, bonds=bonds)
    assert run.config["graph"]
    K = run.config["reuse_steps"]
    data = tengine.plan_data(plan, device=cuda, dtype=torch.float32)
    args = (torch.as_tensor(pos_np, device=cuda).float(),
            torch.as_tensor(solute_velocities(blob["velocities"], kept),
                            device=cuda).float(),
            torch.as_tensor(np.diag([box_len] * 3), device=cuda).float(),
            torch.as_tensor(plan.global_defaults, device=cuda).float(),
            data)
    run(*args, K)
    before = _launches()
    p_g, v_g, e_g = run(*args, 2 * K)
    made_g = _made(before)
    before = _launches()
    p_e, v_e, e_e = run.eager(*args, 2 * K)
    assert made_g == _made(before) and made_g["pair_cell"] == 2 * K
    assert run.stats["replays"] == 2
    assert torch.equal(p_g, p_e) and torch.equal(v_g, v_e)
    assert float(e_g) == float(e_e)


def test_graph_solute_within_tolerance(cuda):
    """The solute box (pair_cell, bonds, the gather constrainer): the
    graph against the eager body over two windows, positions and
    velocities to the bit (the bonds, the 1-4s and M-SHAKE sum each atom's
    terms in a fixed order, without atomics)."""
    _solute_graph_against_eager(cuda, constrained=False)


def test_graph_constrained_solute_equals_eager(cuda):
    """The solute box with the chain's 1-2 pairs as constraints (one
    11-wide cluster, every water triangle padded to it, solved by CGLS)
    and its 1-3 pairs as bonds: the graph captures the wide solve and
    equals the eager body to the bit."""
    _solute_graph_against_eager(cuda, constrained=True)
