"""Fused MD step loop for production throughput.

Leapfrog-Verlet steps with the full sliced nonbonded evaluation, over the
fused engine (``ops/fused.py``).  The neighbour/slot state from ``prepare``
is rebuilt every ``reuse_steps`` (K) steps and reused by the steps between
under a skin guard, the analog of Verlet-list reuse.  One function holds the
body of a window: ``prepare``, then K times (``apply``, bonds, integrate),
then the guard maxima.  On CUDA tensors each window is a replay of one CUDA
graph of that body, the port's counterpart of the JAX package's jitted
``lax.scan`` (:class:`_WindowGraphs`); CPU tensors run the same body
eagerly.  Inner steps run the force-only engine; each ``run()`` ends with
one eager evaluation with energies.  Safety is monitored on the device and
checked on the host once per ``run()``, after the steps:

* ``overflow`` — atoms beyond the static cell capacity (never silently
  dropped; raise and rebuild with a larger capacity)
* ``maxdisp2`` — max squared displacement since the last rebuild; beyond
  (skin/2)^2 the frozen cell assignment may miss pairs
* ``excl_span`` — on the min-image cell kernel's path, every excluded pair
  must lie within one cell width per axis (minimum image): the kernel
  corrects the excluded pairs it meets among the 27 neighbour cells
* the runtime box must equal ``plan.box0``: the cell grid sizing and the
  PME convolution kernels are built once from it

Where the fused engine has no cell grid (no periodic box, or fewer than 3
cells of one cutoff per axis) the steps rebuild everything every step over
the generic engine ``ops/engine.make_compute``, the JAX package's
``_make_md_step_simple``, in graphed windows of :data:`SIMPLE_WINDOW`
steps; no skin guard applies there.

Optionally adds harmonic bonds (flexible intramolecular geometry) to the
forces of every step, with the minimum image on the bond vectors when
``bonds_periodic``.  ``mixed_precision`` carries the positions in float64
(the reference CUDA platform's "mixed" precision): forces, the kick and the
velocities stay float32, the position update and the constraint solve run
in float64.
"""

import functools

import numpy as np
import torch

from ..models.force import OpenMMException
from ..ops import cuda_direct, cuda_pme
from ..ops import engine as engine_mod
from ..ops import fused as fused_mod
from ..ops.geometry import min_image
from ..ops.params import slice_lambdas
from ..utils.indexing import incidence_sums, incidence_table
from . import profiling

# nm — Verlet-list style cell oversizing for MD reuse (as the JAX package)
DEFAULT_SKIN = 0.09
# steps a window of the per-step rebuild path holds (one CUDA graph each)
SIMPLE_WINDOW = 25


def _bond_forces_fn(bonds, n, periodic=False, box=None):
    """forces(pos) (n, 3) of harmonic bonds ``bonds`` (M, 4) rows (i, j, r0,
    k) with energy k/2 (r - r0)^2, or None without bonds.  Bond vectors are
    taken as they are or, with ``periodic``, as their minimum image in the
    static ``box`` (the JAX package's ``fastpath._bond_forces_fn``)."""
    if bonds is None or len(bonds) == 0:
        return None
    bonds = np.asarray(bonds, dtype=np.float64)
    b_i = bonds[:, 0].astype(np.int64)
    b_j = bonds[:, 1].astype(np.int64)
    targets, table = incidence_table(np.concatenate([b_i, b_j]), n)
    host = dict(b_i=b_i, b_j=b_j, r0=bonds[:, 2], k=bonds[:, 3],
                targets=targets, table=table)
    if periodic:
        host["box"] = np.asarray(box, dtype=np.float64)
    cache = {}

    def bond_forces(pos):
        key = (pos.device, pos.dtype)
        if key not in cache:
            cache[key] = {name: torch.as_tensor(v, device=pos.device).to(
                pos.dtype if v.dtype.kind == "f" else torch.int64)
                for name, v in host.items()}
        c = cache[key]
        dr = pos[c["b_i"]] - pos[c["b_j"]]
        if periodic:
            dr = min_image(dr, c["box"])
        r = torch.sqrt(torch.sum(dr * dr, dim=-1))
        dedr = c["k"] * (r - c["r0"]) / torch.clamp(r, min=1e-12)
        f = -dedr[:, None] * dr
        # each atom's bond forces summed in a fixed order, without atomics
        out = torch.zeros((n, 3), dtype=pos.dtype, device=pos.device)
        return out.index_copy_(0, c["targets"],
                               incidence_sums(torch.cat([f, -f]), c["table"]))

    return bond_forces


def make_integrator(masses, dt, dtype, constraints=None):
    """The leapfrog step of the MD loops (``make_md_step`` and
    ``parallel/fused_shard.make_sharded_md_step``):
    integrate(pos, vel, forces) -> (pos, vel).  The kick v += dt F / m in
    ``dtype`` (massless atoms do not move); the update, the constraint
    solve and the velocity from the constrained displacement in the
    positions' dtype (float64 under mixed precision), the velocity stored
    in ``dtype``.  ``constraints`` = (pairs, dists[, mask]) adds the
    projections of ``runtime.constraints.make_constrainer``.
    ``integrate.capturable`` says whether the step can be captured in a
    CUDA graph."""
    m_np = np.asarray(masses, dtype=np.float64)
    inv_m_np = np.where(m_np > 0, 1.0 / np.maximum(m_np, 1e-300), 0.0)[:, None]
    inv_m_dev = {}
    if constraints is not None:
        from .constraints import make_constrainer
        c_mask = constraints[2] if len(constraints) > 2 else None
        proj_x, proj_v = make_constrainer(constraints[0], constraints[1],
                                          masses, len(m_np), mask=c_mask)
    else:
        proj_x = proj_v = None

    def integrate(pos, vel, forces):
        dev = vel.device
        if dev not in inv_m_dev:
            # copied once: a host->device copy cannot be captured
            inv_m_dev[dev] = torch.as_tensor(inv_m_np, device=dev).to(dtype)
        vel = vel + dt * forces * inv_m_dev[dev]
        if proj_x is None:
            return pos + dt * vel.to(pos.dtype), vel
        pos_new = proj_x(pos, pos + dt * vel.to(pos.dtype))
        vel_new = proj_v(pos_new, (pos_new - pos) / dt)
        return pos_new, vel_new.to(vel.dtype)

    integrate.capturable = proj_x is None or proj_x.__self__.capturable
    return integrate


# the kernel wrappers' launch counters (name -> launches).  A replay moves
# no Python, so a capture records what one replay launches, takes it back
# out of the counters, and each replay adds it: the counts stay the number
# of kernels the card ran.
_COUNTERS = (cuda_direct.LAUNCHES, cuda_pme.LAUNCHES)


def _launch_counts():
    return [dict(counter) for counter in _COUNTERS]


def _take_launches(before):
    """The launches counted since ``before`` (a :func:`_launch_counts`), as
    (counter, name, launches) triples; the counters are set back to
    ``before``."""
    made = [(counter, name, counter[name] - old[name])
            for counter, old in zip(_COUNTERS, before) for name in counter
            if counter[name] != old[name]]
    for counter, name, launches in made:
        counter[name] -= launches
    return made


class _WindowGraphs:
    """CUDA graphs of the K-step window, one per window length, on static
    buffers: positions, velocities, box, gvals and the guard accumulators
    ``ov``, ``dmax`` and ``span``.  ``run`` copies its inputs in and replays
    a length's graph once per window.

    A length seen for the first time runs its window eagerly on the real
    state (that fills every lazy cache: index tables, convolution kernels,
    constraint and bond constants, cuFFT plans, cuBLAS workspaces), on the
    side stream that the capture then uses, as PyTorch's CUDA graph notes
    ask; then it is captured, and its later windows replay.  The graphs read
    ``data``'s tensors where they lay at capture: ``data`` tensors at other
    addresses drop every graph, so that only the newest captures are kept.
    A failed capture raises.  ``stats`` counts captures, replays and the
    kernel launches the replays added to the counters; the captures and
    replays are counted in ``profiling``'s ``graph.captures`` and
    ``graph.replays`` too."""

    def __init__(self, window):
        self.window = window
        self.graphs = {}
        self.key = None
        self.buf = None
        self.stream = None
        self.stats = dict(captures=0, replays=0, replayed_launches=0)

    def _bind(self, pos, vel, box, gvals, data):
        key = (pos.device, tuple(pos.shape), tuple(gvals.shape),
               tuple((name, t.data_ptr(), tuple(t.shape), t.dtype)
                     for name, t in data.items()))
        if key == self.key:
            return
        self.graphs.clear()
        self.key = key
        dev = pos.device
        self.buf = dict(
            pos=torch.empty_like(pos), vel=torch.empty_like(vel),
            box=torch.empty_like(box), gvals=torch.empty_like(gvals),
            ov=torch.zeros((), dtype=torch.int64, device=dev),
            dmax=torch.zeros((), dtype=vel.dtype, device=dev),
            span=torch.zeros((), dtype=torch.float64, device=dev))
        self.stream = torch.cuda.Stream(dev)

    def _body(self, k, data):
        b = self.buf
        pos, vel = self.window(k, b["pos"], b["vel"], b["box"], b["gvals"],
                               data, b)
        b["pos"].copy_(pos)
        b["vel"].copy_(vel)

    def _warm_up_and_capture(self, k, data):
        current = torch.cuda.current_stream(self.buf["pos"].device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self._body(k, data)
        current.wait_stream(self.stream)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                self._body(k, data)
        finally:
            launches = _take_launches(before)
        self.graphs[k] = (graph, launches)
        self.stats["captures"] += 1
        profiling.count("graph.captures")

    def run(self, blocks, pos, vel, box, gvals, data):
        """Windows of the lengths in ``blocks`` from the given state;
        returns (positions, velocities, (ov, dmax, span))."""
        self._bind(pos, vel, box, gvals, data)
        b = self.buf
        for name, t in (("pos", pos), ("vel", vel), ("box", box),
                        ("gvals", gvals)):
            b[name].copy_(t)
        for name in ("ov", "dmax", "span"):
            b[name].zero_()
        for k in blocks:
            if k not in self.graphs:
                with profiling.span("nbs.step.capture"):
                    self._warm_up_and_capture(k, data)
                continue
            graph, launches = self.graphs[k]
            graph.replay()
            profiling.count("graph.replays")
            for counter, name, n in launches:
                counter[name] += n
            self.stats["replays"] += 1
            self.stats["replayed_launches"] += sum(n for _, _, n in launches)
        return (b["pos"].clone(), b["vel"].clone(),
                (b["ov"], b["dmax"], b["span"]))


def run_windows(window, graphs, reuse_steps, n_steps, pos, vel, box, gvals,
                data, graphed):
    """``n_steps`` steps in windows of ``reuse_steps`` (K) steps and a
    shorter last one: replays of ``graphs`` (a :class:`_WindowGraphs` of
    ``window``) when ``graphed`` and on CUDA tensors, else ``window``
    called eagerly.  Returns (positions, velocities, (ov, dmax, span)),
    the guard maxima over the windows."""
    n_outer, rem = divmod(int(n_steps), reuse_steps)
    blocks = [reuse_steps] * n_outer + ([rem] if rem else [])
    if graphed and pos.device.type == "cuda":
        return graphs.run(blocks, pos, vel, box, gvals, data)
    dev = pos.device
    acc = dict(ov=torch.zeros((), dtype=torch.int64, device=dev),
               dmax=torch.zeros((), dtype=vel.dtype, device=dev),
               span=torch.zeros((), dtype=torch.float64, device=dev))
    for k in blocks:
        pos, vel = window(k, pos, vel, box, gvals, data, acc)
    return pos, vel, (acc["ov"], acc["dmax"], acc["span"])


def check_guards(ov, dmax, span, disp_limit2, skin, scope=""):
    """Raise OpenMMException after a run whose cell capacity overflowed
    (``ov`` atoms dropped), whose excluded pairs spanned a cell width or
    more (``span``, on the cell kernel's path) or in which an atom moved
    more than skin/2 between rebuilds (``dmax`` the largest squared
    displacement, against ``disp_limit2``); ``scope`` names the run in the
    messages.  One device->host transfer."""
    ov_cell, dmax_h, span_h = profiling.to_list(torch.stack(
        [ov.to(torch.float64), dmax.to(torch.float64), span]))
    if ov_cell > 0:
        raise OpenMMException(
            f"Cell-list capacity overflow ({int(ov_cell)} atoms dropped)"
            f"{scope}: the density fluctuation exceeded the static cell "
            "capacity. Rebuild with a larger cell_capacity.")
    if span_h >= 1.0:
        raise OpenMMException(
            "SlicedNonbondedForce: an excluded pair spans more than one "
            f"neighbor-list cell ({span_h:.3f} cell widths along an "
            "axis); the fused engine corrects only the excluded pairs of "
            "neighbouring cells, so excluded pairs must be bonded-range.")
    if dmax_h > disp_limit2:
        raise OpenMMException(
            f"Neighbor-list skin violation{scope}: an atom moved "
            f"{dmax_h ** 0.5:.4f} nm between rebuilds "
            f"(> skin/2 = {0.5 * skin:.4f} nm). Reduce reuse_steps.")


def make_md_step(plan, masses, dt, *, dtype=torch.float32, cell_capacity=None,
                 reuse_steps=None, constraints=None, target_skin=DEFAULT_SKIN,
                 mixed_precision=False, bonds=None, bonds_periodic=False,
                 pme_pipeline="stencil"):
    """Returns run(pos, vel, box, gvals, data, n_steps) -> (pos, vel, energy).

    Leapfrog Verlet: v += dt*F/m; x += dt*v, with constraint projections
    when ``constraints`` = (pairs, dists[, mask]) is given
    (``runtime.constraints.make_constrainer``).  ``bonds`` is an optional
    (M, 4) array-like of (i, j, r0, k) harmonic bonds added to the forces of
    every step; ``bonds_periodic`` takes their vectors as minimum images in
    the plan's box (a HarmonicBondForce that uses periodic boundary
    conditions), else as they are.  Positions, velocities, box and gvals
    may be numpy arrays or tensors; the run works on the device of ``data``
    (``ops.engine.plan_data``) in ``dtype`` and returns new tensors there,
    ``energy`` as a float64 0-d tensor.  The energy is the nonbonded
    energy, as in the JAX package.

    On CUDA tensors every window of K steps replays a CUDA graph (see
    :class:`_WindowGraphs`); CPU tensors run the same body eagerly.
    ``run.eager`` is the same function without the graph, the reference
    the graph is checked against; ``run.stats`` counts the captures, the
    replays and the kernel launches the replays counted.
    ``run.config["graph"]`` says whether the windows are graphed: every
    constrainer is captured (clusters wider than 3 included: their solve
    is a fixed number of CGLS iterations,
    ``runtime.constraints.cgls_solve``), so it is True.

    ``mixed_precision=True`` (with ``dtype=torch.float32`` only, as in the
    JAX package; ignored otherwise) carries the positions in float64: each
    step casts them to float32 for the force evaluation and the bonds, the
    kick runs in float32 and the velocities stay float32, and the
    position update, the constraint solve and the velocity from the
    constrained displacement run in float64.  ``run()`` then returns
    float64 positions and float32 velocities.

    ``pme_pipeline`` is ``"stencil"`` (whole-grid spread and interpolation)
    or ``"grid"`` (the brick-window pipeline), for every evaluation of the
    run; see ``ops.fused.make_fused_engine``.

    ``reuse_steps`` (K) sets how many steps share one slot rebuild; None
    picks K from the skin and the lightest mass.  Raises OpenMMException
    after the run if the cell capacity overflowed or an atom moved more than
    skin/2 between rebuilds, or, on the min-image cell kernel's path, if an
    excluded pair spans a cell width or more.

    Where the fused engine does not apply (``ops.fused.fused_config`` is
    None: no periodic box, or fewer than 3 cells of one cutoff per axis),
    the run is the per-step rebuild of the JAX package's
    ``_make_md_step_simple`` (its ``fastpath.py:323-375``): every step
    evaluates the generic engine ``ops.engine.make_compute`` (there all
    pairs, and Ewald or PME on the atoms), adds the bonds and integrates
    as above; ``reuse_steps`` is ignored, ``run.config["reuse_steps"]`` is
    1 and ``run.config["route"]`` names the engine's route.  Its steps run
    in windows of :data:`SIMPLE_WINDOW` steps, graphed on CUDA tensors as
    the fused path's are; the atom-space PME spreads in int64 fixed point
    (``ops/pme.spread_fixed``), so a replay equals its eager body to the
    bit there too.  The runtime box may differ from the plan's.
    """
    mixed = bool(mixed_precision) and dtype == torch.float32
    pos_dtype = torch.float64 if mixed else dtype
    n = plan.num_particles
    m_np = np.asarray(masses, dtype=np.float64)
    box0 = None if plan.box0 is None else np.asarray(plan.box0,
                                                      dtype=np.float64)
    bond_forces = _bond_forces_fn(bonds, n, periodic=bonds_periodic,
                                  box=box0)
    integrate = make_integrator(masses, dt, dtype, constraints)
    graph_ok = integrate.capturable
    lam_sources = {}

    def lam_source(dev):
        """The lambda sources on ``dev``, copied once."""
        if dev not in lam_sources:
            lam_sources[dev] = torch.as_tensor(plan.lam_source,
                                               dtype=torch.int64, device=dev)
        return lam_sources[dev]

    def with_bonds(forces, pos32):
        return forces if bond_forces is None else forces + bond_forces(pos32)

    eng = fused_mod.make_fused_engine(plan, cell_capacity=cell_capacity,
                                      target_skin=target_skin, energies=False,
                                      pme_pipeline=pme_pipeline)
    if eng is None:
        compute = engine_mod.make_compute(plan, True, True,
                                          cell_capacity=cell_capacity,
                                          with_aux=True)
        K = SIMPLE_WINDOW
        disp_limit2 = np.inf
        skin = None
        config = dict(reuse_steps=1, route=compute.route)

        def window(k, pos, vel, box, gvals, data, acc):
            """``k`` steps, each with its own evaluation of the generic
            engine; the guard maxima go into ``acc`` in place."""
            for _ in range(k):
                pos32 = pos.to(dtype)
                _, forces, aux = compute(pos32, box, gvals, data)
                pos, vel = integrate(pos, vel, with_bonds(forces, pos32))
                torch.maximum(acc["ov"], aux["overflow"], out=acc["ov"])
                if "excl_span" in aux:
                    torch.maximum(acc["span"], aux["excl_span"],
                                  out=acc["span"])
            return pos, vel

        def final(pos32, box, gvals, data):
            slice_e, _, aux = compute(pos32, box, gvals, data)
            return slice_e, aux["overflow"], aux.get("excl_span")
    else:
        prepare, apply, cfg = eng
        _, apply_full, _ = fused_mod.make_fused_engine(
            plan, cell_capacity=cell_capacity, target_skin=target_skin,
            energies=True, pme_pipeline=pme_pipeline)
        skin = cfg["skin"]
        if reuse_steps is None:
            # steps until the fastest plausible atom covers half the skin:
            # 7 nm/ps for 1 amu hydrogens at 300 K, thermal speeds scale as
            # 1/sqrt(m) (the JAX package's calibration on the 23k
            # rigid-water benchmark); the skin guard still checks every run
            m_min = float(np.min(m_np[m_np > 0])) if np.any(m_np > 0) else 1.0
            v_ref = 7.0 / np.sqrt(max(m_min, 1.008) / 1.008)
            reuse_steps = int(0.5 * skin / (dt * v_ref))
        K = min(25, max(1, int(reuse_steps)))
        disp_limit2 = (0.5 * skin) ** 2 if K > 1 else np.inf
        config = dict(reuse_steps=K, skin=skin,
                      **{k: v for k, v in cfg.items()
                         if k in ("counts", "capacity", "pme_grid",
                                  "dispersion_grid")})

        def window(k, pos, vel, box, gvals, data, acc):
            """One window: the slot rebuild at ``pos``, then ``k`` steps.
            Returns (positions, velocities) and takes the guard maxima into
            ``acc``'s ``ov``, ``dmax`` and ``span`` in place."""
            state = prepare(pos.to(dtype), box, gvals, data)
            for _ in range(k):
                pos32 = pos.to(dtype)
                _, forces, aux = apply(pos32, box, gvals, data, state)
                pos, vel = integrate(pos, vel, with_bonds(forces, pos32))
                torch.maximum(acc["dmax"], aux["maxdisp2"], out=acc["dmax"])
            torch.maximum(acc["ov"], state["overflow"], out=acc["ov"])
            if "excl_span" in state:
                torch.maximum(acc["span"], state["excl_span"],
                              out=acc["span"])
            return pos, vel

        def final(pos32, box, gvals, data):
            state = prepare(pos32, box, gvals, data)
            slice_e, _, _ = apply_full(pos32, box, gvals, data, state)
            return slice_e, state["overflow"], state.get("excl_span")

    graphs = _WindowGraphs(window)

    def check_box(box):
        # the convolution kernel and static cell grid are box0-only
        # (tolerance covers the f32 cast of an f64 default box)
        if torch.is_tensor(box):
            box = profiling.to_host(box.detach())
        if not np.allclose(np.asarray(box, dtype=np.float64), box0, rtol=0.0,
                           atol=1e-6 * float(np.max(np.abs(box0)))):
            raise OpenMMException(
                "make_md_step: the runtime box must equal the plan's default "
                "box (the cell grid and PME convolution kernel are "
                "box-static); reinitialize for a different box.")

    def _run(pos, vel, box, gvals, data, n_steps, graphed):
        dev = data["base_params"].device
        with profiling.span("nbs.step.copy_in"):
            if skin is not None:
                check_box(box)
            box = profiling.to_device(box, dev).to(dtype)
            pos = profiling.to_device(pos, dev).to(pos_dtype)
            vel = profiling.to_device(vel, dev).to(dtype)
            gvals = profiling.to_device(gvals, dev).to(dtype)
        with profiling.span("nbs.step.replay"):
            pos, vel, (ov, dmax, span) = run_windows(
                window, graphs, K, n_steps, pos, vel, box, gvals, data,
                graphed and graph_ok)
        with profiling.span("nbs.step.energy"):
            # the evaluation with energies for the reported energy, eager
            slice_e, ov_final, span_final = final(pos.to(dtype), box, gvals,
                                                  data)
            ov = torch.maximum(ov, ov_final)
            if span_final is not None:
                span = torch.maximum(span, span_final)
            energy = engine_mod.contract_energy(
                slice_e, slice_lambdas(lam_source(dev), gvals))
        with profiling.span("nbs.step.guard"):
            check_guards(ov, dmax, span, disp_limit2, skin)
        return pos, vel, energy

    def run(pos, vel, box, gvals, data, n_steps):
        return _run(pos, vel, box, gvals, data, n_steps, graphed=True)

    run.eager = functools.partial(_run, graphed=False)
    run.stats = graphs.stats
    run.config = dict(config, mixed_precision=mixed, graph=graph_ok,
                      pme_pipeline=pme_pipeline)
    return run
