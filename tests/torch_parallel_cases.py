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
from nonbondedslicing_tpu_torch.parallel import collectives, mesh, pme_shard

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


def water_system(api, n_mol=40, box=3.2, seed=9, nsub=3, method="PME",
                 offsets=False, periodic=False):
    """tests/test_parallel.py::_water_system through ``api``: 40 rigid
    3-site waters on a lattice of a 3.2 nm box (120 atoms), cutoff 0.9 nm,
    triangle exclusions and constraints, one scaling parameter ``lam``
    (0.8) of slice (0, 1); with ``offsets`` two more globals ``qscale``
    (0.6) and ``xscale`` (0.25) carrying charge/epsilon offsets of every
    fifth oxygen and an exception offset; with ``periodic`` the exceptions
    use periodic boundary conditions.  Returns (system, force,
    positions)."""
    rng = np.random.default_rng(seed)
    sys_ = api.System()
    sys_.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0), (0, 0, box))
    force = api.SlicedNonbondedForce(nsub)
    force.setNonbondedMethod(getattr(api.SlicedNonbondedForce, method))
    force.setCutoffDistance(0.9)
    grid = int(np.ceil(n_mol ** (1 / 3)))
    sites = np.stack(np.meshgrid(*[np.arange(grid)] * 3,
                                 indexing="ij"), -1).reshape(-1, 3)
    sites = (sites[:n_mol] + 0.5) * (box / grid)
    positions = np.empty((3 * n_mol, 3))
    d_oh, d_hh = 0.09572, 0.15139
    for m in range(n_mol):
        sys_.addParticle(15.999)
        sys_.addParticle(1.008)
        sys_.addParticle(1.008)
        force.addParticle(-0.834, 0.3151, 0.6364)
        force.addParticle(0.417, 0.04, 0.192)
        force.addParticle(0.417, 0.04, 0.192)
        o = 3 * m
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        perp = np.cross(axis, rng.normal(size=3))
        perp /= np.linalg.norm(perp)
        half = d_hh / 2
        h = np.sqrt(d_oh ** 2 - half ** 2)
        positions[o] = sites[m]
        positions[o + 1] = sites[m] + h * axis + half * perp
        positions[o + 2] = sites[m] + h * axis - half * perp
        for a, b in ((0, 1), (0, 2), (1, 2)):
            force.addException(o + a, o + b, 0.0, 1.0, 0.0)
        for a in range(3):
            force.setParticleSubset(o + a, (m + a) % nsub)
        sys_.addConstraint(o, o + 1, d_oh)
        sys_.addConstraint(o, o + 2, d_oh)
        sys_.addConstraint(o + 1, o + 2, d_hh)
    force.addGlobalParameter("lam", 0.8)
    force.addScalingParameter("lam", 0, 1, True, True)
    if offsets:
        force.addGlobalParameter("qscale", 0.6)
        force.addGlobalParameter("xscale", 0.25)
        for m in range(0, n_mol, 5):
            force.addParticleParameterOffset("qscale", 3 * m, 0.05, 0.0, 0.1)
        force.addExceptionParameterOffset("xscale", 0, 0.02, 0.0, 0.03)
    force.setExceptionsUsePeriodicBoundaryConditions(periodic)
    sys_.addForce(force)
    return sys_, force, positions


def water_md_inputs(method, offsets=False, device="cpu",
                    dtype=torch.float64, periodic=False):
    """(plan, masses, constraint clusters, positions, box, data) of
    :func:`water_system` on ``device`` in ``dtype``."""
    from nonbondedslicing_tpu_torch.runtime.constraints import \
        cluster_constraints
    sys_, force, positions = water_system(nbt, method=method, offsets=offsets,
                                          periodic=periodic)
    plan = tplan.build_plan(force, sys_)
    n = plan.num_particles
    masses = np.array([sys_.getParticleMass(i) for i in range(n)])
    cons = cluster_constraints(
        [sys_.getConstraintParameters(i)
         for i in range(sys_.getNumConstraints())], n)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    return (plan, masses, cons, t(positions), t(plan.box0),
            tengine.plan_data(plan, device=device, dtype=dtype))


def slab_md(group, device, method, gvals, vel_seed, n_steps, offsets=False,
            zeroed=None, periodic=False, reuse_steps=2, cell_capacity=32,
            dtype="float64"):
    """``fused_shard.make_sharded_md_step`` on :func:`water_system` with its
    constraints, ``n_steps`` steps of 1 fs from velocities of 0.3 nm/ps
    made from ``vel_seed``: (positions, velocities, energy, run.config,
    the rank's slab range, the pair kernel's calls on this rank) and, with
    ``zeroed`` globals, the energy of the same run under them; with
    ``periodic``, the exceptions periodic (the pair_cell path)."""
    from nonbondedslicing_tpu_torch.ops import cuda_direct
    from nonbondedslicing_tpu_torch.parallel import fused_shard
    dt = _dtype(dtype)
    plan, masses, cons, pos, box, data = water_md_inputs(
        method, offsets, device, dt, periodic)
    vel = torch.as_tensor(np.random.default_rng(vel_seed).normal(
        scale=0.3, size=tuple(pos.shape)), device=device).to(dt)
    calls = []
    counted = {}
    for name in ("pair_column", "pair_cell"):
        real = getattr(cuda_direct, name)

        def wrapper(*args, _real=real, **kw):
            calls.append(kw.get("cells"))
            return _real(*args, **kw)

        counted[name] = real
        setattr(cuda_direct, name, wrapper)
    try:
        run = fused_shard.make_sharded_md_step(
            plan, masses, 0.001, group, dtype=dt, constraints=cons,
            reuse_steps=reuse_steps, cell_capacity=cell_capacity)
    finally:
        for name, real in counted.items():
            setattr(cuda_direct, name, real)
    p, v, e = run(pos, vel, box, torch.as_tensor(gvals, dtype=dt), data,
                  n_steps)
    ncx, ncy, ncz = run.config["counts"]
    out = dict(pos=p.cpu().numpy(), vel=v.cpu().numpy(), energy=float(e),
               config=run.config, calls=calls,
               slab=collectives.share(ncx * ncy * ncz, group,
                                      quantum=ncy * ncz))
    if zeroed is not None:
        out["energy_zeroed"] = float(run(
            pos, vel, box, torch.as_tensor(zeroed, dtype=dt), data,
            n_steps)[2])
    return out


def slab_guards(group, device):
    """The guards of ``make_sharded_md_step`` on :func:`water_system`
    (PME, float64, no constraints): the messages raised by a run at 4 slots
    a cell (overflow) and by a run whose first atom moves 0.1 nm a step
    (more than half the 0.167 nm skin within one window of 2 steps)."""
    from nonbondedslicing_tpu_torch.parallel import fused_shard
    plan, masses, _, pos, box, data = water_md_inputs("PME")
    gvals = torch.as_tensor(plan.global_defaults)
    out = {}
    for name, capacity, speed in (("overflow", 4, 0.0), ("skin", 32, 100.0)):
        run = fused_shard.make_sharded_md_step(
            plan, masses, 0.001, group, dtype=torch.float64,
            reuse_steps=2, cell_capacity=capacity)
        vel = torch.zeros_like(pos)
        vel[0, 0] = speed
        try:
            run(pos, vel, box, gvals, data, 2)
            out[name] = None
        except nbt.OpenMMException as exc:
            out[name] = str(exc)
    return out


def slab_one_rank(group, device):
    """Each rank builds ``make_sharded_md_step`` in a group of its own (a
    1-rank gloo group) and runs 5 steps of PME as :func:`slab_md`; the
    refusal of a box too small for a cell grid is raised there too.
    Returns (the run's output, the refusal's message)."""
    rank, size = collectives.rank_and_size(group)
    mine = [dist.new_group([r], backend="gloo") for r in range(size)][rank]
    out = slab_md(mine, device, "PME", [0.8], 4, 5)
    from nonbondedslicing_tpu_torch.parallel import fused_shard
    sys_, force, _ = system(nbt, "PME", box=2.4)
    try:
        fused_shard.make_sharded_md_step(tplan.build_plan(force, sys_),
                                         np.ones(64), 0.001, mine)
        refusal = None
    except nbt.OpenMMException as exc:
        refusal = str(exc)
    return out, refusal


def slab_card(group, device, plan, positions, velocities, masses,
              constraints, n_steps, dt=0.002, reuse_steps=None,
              cell_capacity=None, alone=False):
    """``make_sharded_md_step`` in float32 on ``device`` from the given
    state (with ``alone``, in a 1-rank gloo group of this rank's own):
    ``n_steps`` steps counted (the pair kernels' launches of the run),
    the energy at the starting state, then, where the windows are graphed, two windows of the graph against
    two of the eager body from the state reached and one more run (no
    capture may follow the first).  Returns numpy arrays and numbers."""
    from nonbondedslicing_tpu_torch.ops import cuda_direct
    from nonbondedslicing_tpu_torch.parallel import fused_shard
    if alone:
        rank, size = collectives.rank_and_size(group)
        group = [dist.new_group([r], backend="gloo")
                 for r in range(size)][rank]
    f32 = torch.float32
    run = fused_shard.make_sharded_md_step(
        plan, masses, dt, group, dtype=f32, constraints=constraints,
        reuse_steps=reuse_steps, cell_capacity=cell_capacity)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device).to(f32)

    box, gvals = t(plan.box0), t(plan.global_defaults)
    data = tengine.plan_data(plan, device=device, dtype=f32)
    before = dict(cuda_direct.LAUNCHES)
    p, v, e = run(t(positions), t(velocities), box, gvals, data, n_steps)
    torch.cuda.synchronize()
    out = dict(pos=p.cpu().numpy(), vel=v.cpu().numpy(), energy=float(e),
               config=run.config,
               launches={k: n - before[k]
                         for k, n in cuda_direct.LAUNCHES.items()
                         if n != before[k]})
    # the energy at the starting state (a run of no steps)
    out["energy_start"] = float(run(t(positions), t(velocities), box, gvals,
                                    data, 0)[2])
    if run.config["graph"]:
        K = run.config["reuse_steps"]
        captures = run.stats["captures"]
        graphed = run(p, v, box, gvals, data, 2 * K)
        eager = run.eager(p, v, box, gvals, data, 2 * K)
        run(p, v, box, gvals, data, 2 * K)
        out["graph"] = dict(
            pos=[x[0].cpu().numpy() for x in (graphed, eager)],
            vel=[x[1].cpu().numpy() for x in (graphed, eager)],
            energy=[float(x[2]) for x in (graphed, eager)],
            captures=(captures, run.stats["captures"]))
    return out
