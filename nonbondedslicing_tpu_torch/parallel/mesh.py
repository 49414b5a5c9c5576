"""The sharded evaluation over a ``torch.distributed`` group (the JAX
package's ``parallel/mesh.py``).

The reference splits a system over several GPUs with a context per device,
host threads and a host-side energy sum
(CudaParallelNonbondedSlicingKernels.cpp:19-66).  Here every rank holds
the whole input and computes a share of the work:

* periodic cutoff methods with a cell grid: ``ops/engine.make_compute``
  with ``shard=group``, whose cell list (the kernel route ``pair_cell`` at
  1,024 atoms or more, else the plain cell list) splits the cells among
  the ranks, and whose reciprocal part splits the atoms
  (``parallel/pme_shard.py``);
* otherwise (NoCutoff, CutoffNonPeriodic, periodic boxes under 3 cells per
  axis): the all-pairs rows in whole blocks per rank, the side terms
  (exclusion corrections, 1-4s, dispersion correction) on every rank, and
  the reciprocal part as above.

Slice energies and forces are summed over the group, so every rank returns
the same full result.  :func:`make_multichip_md_step` is a test harness:
one sharded evaluation and an unconstrained leapfrog per step.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..models.force import NonbondedForce
from ..ops import bonded, direct, engine, neighbors, params
from ..ops.geometry import box_volume
from ..ops.plan import EWALD_METHODS, Plan
from ..utils.constants import COUL, VDW
from . import collectives


def make_sharded_compute(plan: Plan, group=None, block_size=None):
    """Returns f(positions, box, gvals, data) -> (slice_energies (S, 2)
    float64, forces (N, 3)) evaluated over the ranks of ``group`` (None:
    the world group), each calling it with the same inputs on its own
    device; every rank gets the same full result.  ``block_size``
    overrides the all-pairs row block."""
    group = dist.group.WORLD if group is None else group
    _, size = collectives.rank_and_size(group)
    method = plan.method
    n = plan.num_particles
    nslices = plan.num_slices
    periodic = method in (NonbondedForce.CutoffPeriodic,) + tuple(
        EWALD_METHODS)

    # periodic cutoff systems: the cell list split over cells
    if periodic and neighbors.choose_cell_grid(plan.box0, plan.cutoff,
                                               n) is not None:
        neighbor = ("pallas" if n >= engine._CELL_LIST_MIN_PARTICLES
                    else "cell")
        return engine.make_compute(plan, True, True, neighbor=neighbor,
                                   shard=group)

    if method == NonbondedForce.NoCutoff:
        mode = direct.PLAIN
    elif method in (NonbondedForce.CutoffNonPeriodic,
                    NonbondedForce.CutoffPeriodic):
        mode = direct.CUTOFF
    else:
        mode = direct.EWALD_DIRECT
    eps_rf = plan.rf_dielectric
    krf = plan.cutoff ** -3 * (eps_rf - 1.0) / (2.0 * eps_rf + 1.0)
    crf = (1.0 / plan.cutoff) * (3.0 * eps_rf) / (2.0 * eps_rf + 1.0)
    # rows per rank in whole blocks (mesh.py:88-91)
    block = block_size or direct._pick_block(max(n // size, 8))
    direct_fn = direct.make_direct_space(
        mode=mode, periodic=periodic, cutoff=plan.cutoff, krf=krf, crf=crf,
        use_switch=plan.use_switch, switch_distance=plan.switch_distance,
        ewald_alpha=plan.ewald_alpha,
        ljpme=(method == NonbondedForce.LJPME),
        dispersion_alpha=plan.dispersion_alpha, num_slices=nslices,
        block_size=block)
    # the reciprocal part: the engine with the direct space off, sharded
    recip_compute = engine.make_compute(plan, False, True, shard=group)

    def compute(positions, box, gvals, data):
        dtype = positions.dtype
        box = box.to(dtype)
        gvals = gvals.to(dtype)
        subsets = data["subsets"]
        charge, sig_half, eps2 = params.particle_params(data, gvals)
        lam = params.slice_lambdas(plan.lam_source, gvals)
        lam_c, lam_v = lam[:, COUL], lam[:, VDW]
        begin, end = collectives.share(n, group, quantum=block)
        e_dir, f_rows = direct_fn(positions, box, charge, sig_half, eps2,
                                  subsets, data["exclusion_list"],
                                  plan.slice_table, lam_c, lam_v,
                                  rows=(begin, end))
        slice_e = collectives.all_reduce(e_dir, group)
        forces = collectives.assemble(f_rows, begin, n, group)
        # the rest on every rank, after the sums: added once
        e_rest, f_rest = _direct_side_terms(plan, positions, box, gvals,
                                            data, charge, sig_half, eps2,
                                            subsets, lam_c, lam_v)
        slice_e = slice_e + e_rest
        forces = forces + f_rest
        if method in EWALD_METHODS:
            e_recip, f_recip = recip_compute(positions, box, gvals, data)
            slice_e = slice_e + e_recip
            forces = forces + f_recip
        return slice_e, forces

    compute.route = "all_pairs"
    return compute


def _direct_side_terms(plan, positions, box, gvals, data, charge, sig_half,
                       eps2, subsets, lam_c, lam_v):
    """Exclusion corrections + 1-4s + dispersion correction (replicated):
    (slice energies (S, 2) float64, forces (N, 3))."""
    method = plan.method
    n = plan.num_particles
    nslices = plan.num_slices
    dev = positions.device
    slice_e = torch.zeros((nslices, 2), dtype=torch.float64, device=dev)
    forces = torch.zeros((n, 3), dtype=positions.dtype, device=dev)
    if method in EWALD_METHODS:
        e_x, f_x = bonded.exclusion_corrections(
            positions, box, data["exclusion_pairs"], charge, sig_half, eps2,
            subsets, plan.slice_table, lam_c, lam_v,
            alpha=plan.ewald_alpha,
            periodic_exceptions=plan.exceptions_periodic,
            ljpme=(method == NonbondedForce.LJPME),
            dispersion_alpha=plan.dispersion_alpha,
            num_slices=nslices, num_particles=n)
        slice_e = slice_e + e_x
        forces = forces + f_x
    sigma14, four_eps14, qq14 = params.nb14_params(data, gvals)
    e_14, f_14 = bonded.nb14_interactions(
        positions, box, data["nb14_atoms"], sigma14, four_eps14, qq14,
        data["nb14_slice"], lam_c, lam_v,
        periodic=plan.exceptions_periodic, num_slices=nslices,
        num_particles=n)
    slice_e = slice_e + e_14
    forces = forces + f_14
    if method in (NonbondedForce.CutoffPeriodic, NonbondedForce.Ewald,
                  NonbondedForce.PME):
        slice_e[:, VDW] += (data["dispersion_coefficients"].to(torch.float64)
                            / box_volume(box).to(torch.float64))
    return slice_e, forces


def make_multichip_md_step(plan: Plan, masses, dt, group=None,
                           dtype=torch.float32):
    """Test harness only (as in the JAX package): one sharded evaluation
    and an unconstrained leapfrog per step,
    step(pos, vel, box, gvals, data) -> (pos, vel, energy), the energy
    (0-d float64) of the positions the step started from.  ``masses``
    (N,) numpy; massless atoms do not move."""
    compute = make_sharded_compute(plan, group)
    masses = np.asarray(masses, dtype=np.float64)
    inv_m_np = np.where(masses > 0, 1.0 / np.maximum(masses, 1e-300),
                        0.0)[:, None]
    inv_m = {}

    def step(pos, vel, box, gvals, data):
        dev = pos.device
        if dev not in inv_m:
            inv_m[dev] = torch.as_tensor(inv_m_np, device=dev).to(dtype)
        slice_e, forces = compute(pos, box, gvals, data)
        vel = vel + dt * forces * inv_m[dev]
        pos = pos + dt * vel
        lam = params.slice_lambdas(plan.lam_source, gvals.to(pos.dtype))
        energy = engine.contract_energy(slice_e, lam)
        return pos, vel, energy

    return step
