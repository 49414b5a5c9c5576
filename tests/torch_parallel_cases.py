"""Ranks of the sharded evaluation for the tests, and their cases.

:func:`run_ranks` spawns one process per rank, joins a ``torch.distributed``
group through a ``file://`` rendezvous in a fresh directory (no TCP port,
so tests on one host do not collide), runs a list of jobs in every rank
and returns each rank's results.  A rank that fails or does not finish in
time fails the call, which names it.  Spawned children import the module
of their target, so this module imports torch, numpy and the port only
(never JAX); import it as ``torch_parallel_cases`` (on the GPU machine a
site package named ``tests`` shadows ``tests.``).  ``chip_smoke.py`` runs
its ranks through it too.

A job is (name, "module:function", kwargs); the function is called as
``function(group, device, **kwargs)`` in every rank and returns numpy
arrays (or anything picklable), which come back under ``name``.
"""

import importlib
import multiprocessing
import multiprocessing.connection
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.parallel import mesh, pme_shard

RANK_TIMEOUT = 120.0      # s, the whole spawn


def _rank(rank, world, workdir, jobs, backend, device):
    """One rank: join the group, run the jobs, write the results."""
    try:
        torch.set_num_threads(1)
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device).index or 0)
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(workdir, "init"),
            rank=rank, world_size=world)
        try:
            out = {}
            for name, target, kwargs in jobs:
                module, fn = target.split(":")
                out[name] = getattr(importlib.import_module(module), fn)(
                    dist.group.WORLD, device, **kwargs)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def run_ranks(world, workdir, jobs, backend="gloo", devices=None,
              timeout=RANK_TIMEOUT):
    """Run ``jobs`` in ``world`` spawned ranks (rank r on ``devices[r]``,
    default the CPU) over ``backend``; returns the list of each rank's
    results.  ``workdir`` must be a new, empty directory.  Raises
    RuntimeError naming the rank if one exits with an error (its
    traceback included) or if any is still running after ``timeout``
    seconds (all are then killed)."""
    devices = devices or ["cpu"] * world
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, workdir, jobs,
                                             backend, devices[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            left = deadline - time.monotonic()
            if left <= 0:
                late = [r for r, p in enumerate(procs) if p.is_alive()]
                raise RuntimeError(f"rank(s) {late} of {world} did not "
                                   f"finish within {timeout:.0f} s")
            multiprocessing.connection.wait(
                [p.sentinel for p in procs if p.is_alive()], timeout=left)
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                r = failed[0]
                err = os.path.join(workdir, f"rank{r}.err")
                why = (open(err).read() if os.path.exists(err)
                       else f"exit code {procs[r].exitcode}")
                raise RuntimeError(f"rank {r} of {world} failed:\n{why}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def system(api, method, n_mol=32, box=3.0, seed=3):
    """tests/test_parallel.py::_system through ``api``: 32 two-site
    molecules (64 atoms) at random in a 3.0 nm box, cutoff 0.9 nm, three
    subsets, one scaling parameter ``lam`` (0.7) of slice (0, 1).  Returns
    (system, force, positions)."""
    rng = np.random.default_rng(seed)
    sys_ = api.System()
    sys_.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0), (0, 0, box))
    force = api.SlicedNonbondedForce(3)
    force.setNonbondedMethod(getattr(api.SlicedNonbondedForce, method))
    force.setCutoffDistance(0.9)
    positions = rng.random((2 * n_mol, 3)) * box
    for k in range(n_mol):
        sys_.addParticle(16.0)
        sys_.addParticle(1.0)
        force.addParticle(-0.5, 0.3, 0.5)
        force.addParticle(0.5, 0.1, 0.0)
        force.addException(2 * k, 2 * k + 1, 0.0, 1.0, 0.0)
        force.setParticleSubset(2 * k, k % 3)
        force.setParticleSubset(2 * k + 1, k % 3)
    force.addGlobalParameter("lam", 0.7)
    force.addScalingParameter("lam", 0, 1, True, True)
    sys_.addForce(force)
    return sys_, force, positions


def port_inputs(method, device, dtype, box=3.0):
    """(plan, positions, box, gvals, data) of :func:`system` (in a cubic
    box of edge ``box``) on ``device`` in ``dtype``."""
    sys_, force, positions = system(nbt, method, box=box)
    plan = tplan.build_plan(force, sys_)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    return (plan, t(positions), t(plan.box0), t(plan.global_defaults),
            tengine.plan_data(plan, device=device, dtype=dtype))


def _dtype(name):
    return getattr(torch, name)


def sharded_compute(group, device, method, dtype="float64", box=3.0):
    """``mesh.make_sharded_compute`` of :func:`system`: (route, slice
    energies, forces)."""
    plan, pos, box, gvals, data = port_inputs(method, device, _dtype(dtype),
                                              box)
    compute = mesh.make_sharded_compute(plan, group)
    e, f = compute(pos, box, gvals, data)
    return compute.route, e.cpu().numpy(), f.cpu().numpy()


def sharded_engine(group, device, method, neighbor, dtype="float32",
                   include=(True, True)):
    """``engine.make_compute(..., shard=group, with_aux=True)`` of
    :func:`system`: (route, slice energies, forces, overflow)."""
    plan, pos, box, gvals, data = port_inputs(method, device, _dtype(dtype))
    compute = tengine.make_compute(plan, *include, neighbor=neighbor,
                                   shard=group, with_aux=True)
    e, f, aux = compute(pos, box, gvals, data)
    return (compute.route, e.cpu().numpy(), f.cpu().numpy(),
            int(aux["overflow"]))


def sharded_reciprocal(group, device, kind):
    """``pme_shard.make_sharded_pme`` (kind "pme", or "dispersion": LJPME's
    C6 term) or ``make_sharded_ewald`` ("ewald") in float64 on the
    charges (or C6) of :func:`system`: (slice energies, forces)."""
    method = {"pme": "PME", "dispersion": "LJPME", "ewald": "Ewald"}[kind]
    plan, pos, box, gvals, data = port_inputs(method, device, torch.float64)
    args = reciprocal_args(plan, data, gvals, kind)
    n = plan.num_particles
    tables = dict(num_subsets=plan.num_subsets,
                  slice_subset_pairs=args["pairs"],
                  slice_table=plan.slice_table)
    if kind == "ewald":
        fn = pme_shard.make_sharded_ewald(
            group, n, kvec_ints=args["kvec"], alpha=plan.ewald_alpha,
            **tables)
    else:
        fn = pme_shard.make_sharded_pme(
            group, n, alpha=args["alpha"], grid_shape=args["grid"],
            moduli=args["moduli"], dispersion=kind == "dispersion",
            **tables)
    e, f = fn(pos, box, args["values"], data["subsets"], args["lam"])
    return e.cpu().numpy(), f.cpu().numpy()


def reciprocal_args(plan, data, gvals, kind):
    """What a reciprocal term of ``plan`` takes: per-atom values (charges,
    or C6), the slice lambdas of its kind, its alpha, grid and moduli (PME)
    or k-vectors (Ewald), and the slice -> subset pairs."""
    from nonbondedslicing_tpu_torch.ops import ewald, params
    from nonbondedslicing_tpu_torch.utils.indexing import slice_subsets
    charge, sig_half, eps2 = params.particle_params(data, gvals)
    lam = params.slice_lambdas(plan.lam_source, gvals)
    out = dict(pairs=slice_subsets(plan.num_subsets))
    if kind == "dispersion":
        out.update(values=8.0 * sig_half ** 3 * eps2, lam=lam[:, 1],
                   alpha=plan.dispersion_alpha, grid=plan.dispersion_grid,
                   moduli=plan.dpme_moduli)
    else:
        out.update(values=charge, lam=lam[:, 0], alpha=plan.ewald_alpha,
                   grid=plan.pme_grid, moduli=plan.pme_moduli)
    if kind == "ewald":
        out["kvec"] = ewald.half_space_kvectors(plan.ewald_kmax)
    return out


def md_steps(group, device, method="PME", n_steps=2, dt=0.001):
    """``mesh.make_multichip_md_step`` in float64 from :func:`system` at
    rest: the positions, velocities and energy after each step."""
    plan, pos, box, gvals, data = port_inputs(method, device, torch.float64)
    masses = np.tile([16.0, 1.0], plan.num_particles // 2)
    step = mesh.make_multichip_md_step(plan, masses, dt, group,
                                       dtype=torch.float64)
    vel = torch.zeros_like(pos)
    out = []
    for _ in range(n_steps):
        pos, vel, energy = step(pos, vel, box, gvals, data)
        out.append((pos.cpu().numpy(), vel.cpu().numpy(), float(energy)))
    return out


def sharded_plan(group, device, plan, positions):
    """``mesh.make_sharded_compute`` of ``plan`` at ``positions`` in
    float32, and its direct space alone on the same route: (route, slice
    energies, forces, direct-space forces)."""
    args = [torch.as_tensor(np.asarray(x), device=device).float()
            for x in (positions, plan.box0, plan.global_defaults)]
    args.append(tengine.plan_data(plan, device=device, dtype=torch.float32))
    compute = mesh.make_sharded_compute(plan, group)
    e, f = compute(*args)
    direct = tengine.make_compute(plan, True, False, neighbor=compute.route,
                                  shard=group)
    return (compute.route, e.cpu().numpy(), f.cpu().numpy(),
            direct(*args)[1].cpu().numpy())
