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

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 machine)")
    return torch.device("cuda")


def _water(n_mol=512, seed=3):
    """Rigid-water lattice through the port's API (3 cells per axis)."""
    rng = np.random.default_rng(seed)
    n_atoms = 3 * n_mol
    box = float(np.cbrt(n_atoms / 100.2))
    system = nbt.System()
    system.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0), (0, 0, box))
    force = nbt.SlicedNonbondedForce(3)
    force.setNonbondedMethod(nbt.SlicedNonbondedForce.PME)
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
    return dict(prep=prep, app=app, cfg=cfg, data=data, pos=pos, box=box,
                gvals=gvals, st=st, slot_pos=slot_pos)


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
            st["sexcl"], lam, lam * 0.9, s["box"], cfg, energies)
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


def test_pme_kernels_match_plain(cuda):
    plan, positions = _water()
    s = _state(plan, positions, cuda)
    st = s["st"]
    grid_shape = s["cfg"]["pme_grid"]
    recip = recip_box_vectors(s["box"])
    grid_k = cuda_pme.pme_spread(s["slot_pos"], st["slot_q"], st["slot_sub"],
                                 recip, grid_shape, plan.num_subsets)
    grid_p = cuda_pme.pme_spread_plain(s["slot_pos"], st["slot_q"],
                                       st["slot_sub"], recip, grid_shape,
                                       plan.num_subsets)
    torch.cuda.synchronize()
    assert float((grid_k - grid_p).abs().max()) <= 2e-5 * float(
        grid_p.abs().max())
    # fixed-point atomics: the spread grid is bitwise repeatable
    grid_k2 = cuda_pme.pme_spread(s["slot_pos"], st["slot_q"],
                                  st["slot_sub"], recip, grid_shape,
                                  plan.num_subsets)
    assert torch.equal(grid_k, grid_k2)

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


def test_fused_engine_on_card_matches_cpu_f64(cuda):
    plan, positions = _water()
    s = _state(plan, positions, cuda)
    e_g, f_g, _ = s["app"](s["pos"], s["box"], s["gvals"], s["data"], s["st"])
    prep, app, _ = tfused.make_fused_engine(plan, energies=True)
    data = tengine.plan_data(plan, dtype=torch.float64)
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
