"""Hard shapes for the two pair kernels, shared by the CPU tests of their
plain twins (tests/test_torch_pair.py, tests/test_torch_pair_cell.py) and
the tests of the CUDA kernels on the card (tests/test_torch_gpu_kernels.py).

A case is made from a seed with numpy as raw per-atom arrays (what the
all-pairs oracles take) and cut into the slot tensors the kernels take, as
``ops/fused.py`` cuts them: wrapped positions with far-away pads for the
column kernel, raw positions (some atoms moved by whole box vectors) for
the cell kernel.  This module imports torch and the port only.
"""

import numpy as np
import torch

from nonbondedslicing_tpu_torch.ops import cuda_direct, neighbors
from nonbondedslicing_tpu_torch.utils.constants import ONE_4PI_EPS0
from nonbondedslicing_tpu_torch.utils.ewald_params import ewald_alpha
from nonbondedslicing_tpu_torch.utils.indexing import slice_subsets

CUTOFF = 0.75        # unless a case sets its own
WIDTH = 0.8          # cell width of the rectangular boxes, >= the cutoff

# cells, slots per cell, atoms, subsets, exclusion-list width and the size
# of the mutually excluded groups of consecutive atoms, then what else the
# case sets.  Defaults: Ewald, no switch, a rectangular box, unwrapped
# exclusion corrections, uniformly random positions.
PAIR_CASES = {
    # a capacity that is no multiple of 32: the last test step of a staged
    # tile is partly beyond it
    "odd_capacity": dict(cells=(3, 3, 3), capacity=60, n=1050, nsub=3,
                         emax=2, group=3),
    # more slots than fit one staged tile: the queue and the row's sums
    # persist across tiles, and a cell is cut into ten blocks
    "large_capacity": dict(cells=(3, 3, 3), capacity=300, n=5600, nsub=2,
                           emax=2, group=3),
    "eight_subsets": dict(cells=(3, 3, 3), capacity=68, n=780, nsub=8,
                          emax=2, group=3),
    # every atom excludes 16 others: full lists
    # (0.1 nm apart, as bonded atoms are: at 0.03 nm the float32 rounding of
    # erf in 16 corrections per atom outgrows 2e-5 of the net force)
    "full_exclusions": dict(cells=(3, 3, 3), capacity=60, n=40 * 17, nsub=3,
                            emax=16, group=17, spacing=0.1),
    "switch": dict(cells=(3, 3, 3), capacity=52, n=780, nsub=3, emax=2,
                   group=3, use_switch=True),
    "reaction_field": dict(cells=(3, 3, 3), capacity=68, n=780, nsub=3,
                           emax=4, group=3, reaction_field=True),
    # a cutoff so close to the cell width (0.8 nm, a third of the box) that
    # the cell kernel's blocks whose atoms span their whole cell cannot
    # take one frame of images for the block, and others can
    "tight_cutoff": dict(cells=(3, 3, 3), capacity=68, n=780, nsub=3, emax=2,
                         group=3, cutoff=0.795),
    "triclinic": dict(cells=(3, 3, 3), capacity=72, n=1200, nsub=3, emax=2,
                      group=3, triclinic=True, exceptions_periodic=True),
    "grid_3x4x5": dict(cells=(3, 4, 5), capacity=70, n=2200, nsub=3, emax=2,
                       group=3, exceptions_periodic=True),
    # 240 atoms within 0.3 nm of a corner shared by 8 cells, so that every
    # real candidate of a row there is a hit and the queue fills on every
    # test step; the other 19 cells are empty or all pads; an excluded
    # dimer far from everything (rows whose only hits are excluded
    # partners) and a lone atom (a row with no hit)
    "dense_and_empty": dict(cells=(3, 3, 3), capacity=48, n=243, nsub=3,
                            emax=2, group=1, layout="corner"),
}


def _box(case):
    lengths = WIDTH * np.asarray(case["cells"], dtype=np.float64)
    box = np.diag(lengths)
    if case.get("triclinic"):
        box = np.diag(lengths * 1.15)
        box[1, 0] = 0.35
        box[2, 0] = -0.3
        box[2, 1] = 0.4
        widths = neighbors._perpendicular_widths(box)
        assert np.all(widths >= 3 * CUTOFF), widths
    return box


def _positions(case, box, rng):
    """Groups on a jittered lattice of the box (so that atoms of different
    groups keep apart and the LJ forces stay moderate), their members
    ``spacing`` (0.03 nm) apart: every excluded pair spans less than a
    cell."""
    n, group = case["n"], case["group"]
    if case.get("layout") == "corner":
        m = np.arange(-5, 6) * 0.07
        sites = np.stack(np.meshgrid(m, m, m, indexing="ij"), -1).reshape(-1, 3)
        sites = sites[np.argsort(np.linalg.norm(sites, axis=1),
                                 kind="stable")[:n - 3]]
        ball = WIDTH + sites + rng.uniform(-0.01, 0.01, sites.shape)
        dimer = np.array([[2.0, 2.0, 2.0], [2.05, 2.03, 1.98]])
        lone = np.array([[2.0, 0.4, 2.0]])
        return np.concatenate([ball, dimer, lone])
    n_groups = -(-n // group)
    lengths = np.diag(box)
    per_axis = np.ceil(lengths * (n_groups / np.prod(lengths)) ** (1 / 3)
                       ).astype(int)
    sites = np.stack(np.meshgrid(*[np.arange(m) for m in per_axis],
                                 indexing="ij"), -1).reshape(-1, 3)
    sites = sites[rng.permutation(len(sites))[:n_groups]]
    frac = (sites + 0.5 + rng.uniform(-0.2, 0.2, sites.shape)) / per_axis
    member = np.stack(np.unravel_index(np.arange(group), (3, 3, 2)), -1)
    pos = ((frac @ box)[:, None, :]
           + case.get("spacing", 0.03) * member[None, :, :])
    return pos.reshape(-1, 3)[:n]


def _exclusions(case):
    """(exclusion list (n, emax) padded with -1, pairs (E, 2) with i < j)."""
    n, emax, group = case["n"], case["emax"], case["group"]
    excl = np.full((n, emax), -1, dtype=np.int32)
    pairs = []
    if case.get("layout") == "corner":
        groups = [(n - 3, n - 2)]
    else:
        groups = [tuple(range(a, min(a + group, n)))
                  for a in range(0, n, group)]
    for members in groups:
        for i in members:
            others = [j for j in members if j != i]
            excl[i, :len(others)] = others
            pairs += [(i, j) for j in others if i < j]
    return excl, np.asarray(pairs, dtype=np.int64).reshape(-1, 2)


def pair_case_arrays(name):
    """The raw arrays of case ``name`` (numpy, float64): what an all-pairs
    oracle takes."""
    case = PAIR_CASES[name]
    rng = np.random.default_rng(sorted(PAIR_CASES).index(name) + 40)
    n, nsub = case["n"], case["nsub"]
    box = _box(case)
    wrapped = _positions(case, box, rng)
    frac = wrapped @ np.linalg.inv(box)
    wrapped = (frac - np.floor(frac)) @ box
    # the cell kernel's positions: every third atom in another image
    images = np.where((np.arange(n) % 3 == 0)[:, None],
                      rng.integers(-2, 3, size=(n, 3)), 0)
    excl, pairs = _exclusions(case)
    nslices = nsub * (nsub + 1) // 2
    table = np.zeros((nsub, nsub), dtype=np.int32)
    for s, (a, b) in enumerate(slice_subsets(nsub)):
        table[a, b] = table[b, a] = s
    reaction_field = bool(case.get("reaction_field"))
    cutoff = case.get("cutoff", CUTOFF)
    eps_rf = 78.3
    return dict(
        box=box, wrapped=wrapped, raw=wrapped + images @ box,
        charge=rng.uniform(-0.6, 0.6, n), sig_half=rng.uniform(0.01, 0.03, n),
        eps2=rng.uniform(0.5, 1.5, n),
        subsets=rng.integers(0, nsub, n).astype(np.int32),
        exclusion_list=excl, exclusion_pairs=pairs, slice_table=table,
        lam_c=rng.uniform(0.3, 1.0, nslices),
        lam_v=rng.uniform(0.3, 1.0, nslices),
        cfg=cuda_direct.PairConfig(
            counts=case["cells"], capacity=case["capacity"], nsub=nsub,
            emax=case["emax"],
            mode=(cuda_direct.MODE_REACTION_FIELD if reaction_field
                  else cuda_direct.MODE_EWALD),
            cutoff=cutoff,
            krf=cutoff ** -3 * (eps_rf - 1.0) / (2.0 * eps_rf + 1.0),
            crf=(1.0 / cutoff) * (3.0 * eps_rf) / (2.0 * eps_rf + 1.0),
            ewald_alpha=0.0 if reaction_field else ewald_alpha(cutoff, 5e-4),
            use_switch=bool(case.get("use_switch")),
            switch_distance=0.6 if case.get("use_switch") else 0.0,
            exceptions_periodic=bool(case.get("exceptions_periodic"))))


def pair_case_slots(arrays, cell_kernel, device, dtype):
    """The slot tensors of a case on ``device``: the arguments of
    ``pair_cell`` (raw positions) or ``pair_column`` (wrapped positions)
    up to ``cfg``, and ``inv_slots`` (atom -> slot)."""
    cfg = arrays["cfg"]
    n = arrays["charge"].shape[0]
    g, C = cfg.n_cells, cfg.capacity

    def dev(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dt)

    box = dev(arrays["box"])
    pos = dev(arrays["raw"] if cell_kernel else arrays["wrapped"])
    # cells from float64, so that every dtype and device cuts the same slots
    table, overflow = neighbors.build_occupancy(
        neighbors.cell_ids(torch.as_tensor(arrays["wrapped"]),
                           torch.as_tensor(arrays["box"]), cfg.counts),
        n, cfg.counts, C)
    assert int(overflow) == 0
    table = table.to(device)
    slots = table.reshape(-1).long()
    pad = torch.where(slots == n, 4096.0 + 64.0 * torch.arange(
        slots.shape[0], device=device), 0.0).to(dtype).reshape(g, 1, C)
    pad3 = torch.cat([pad, pad.new_zeros((g, 2, C))], dim=1)

    def to_slots(per_atom, fill):
        padded = torch.cat([per_atom, torch.full_like(per_atom[:1], fill)])
        return padded[slots].reshape(g, C, -1).transpose(1, 2).contiguous()

    par = torch.stack([dev(arrays["charge"]), dev(arrays["sig_half"]),
                       dev(arrays["eps2"])], dim=1)
    i32 = torch.int32
    lam_c, lam_v = dev(arrays["lam_c"]), dev(arrays["lam_v"])
    sl_tab = dev(arrays["slice_table"], torch.int64)
    inv_slots = torch.zeros(n + 1, dtype=torch.int64, device=device)
    inv_slots[slots] = torch.arange(slots.shape[0], device=device)
    return dict(
        args=((to_slots(pos, 0.0) + pad3).contiguous(), to_slots(par, 0.0),
              to_slots(dev(arrays["subsets"], i32)[:, None], 0)[:, 0]
              .contiguous(), table,
              to_slots(dev(arrays["exclusion_list"], i32), -1),
              lam_c[sl_tab].contiguous(), lam_v[sl_tab].contiguous(), box,
              cfg),
        inv_slots=inv_slots[:n])


def erfc_budget(arrays):
    """What the kernels' erfc polynomial (A&S 7.1.26, absolute error at most
    1.5e-7, also in erf = 1 - erfc of the exclusion corrections) may move
    against an exact erfc: per atom the force, k |q_i q_j| 1.5e-7 / r^2
    summed over its pairs within the cutoff and its excluded pairs, (n, 1);
    and a slice energy, k |q_i q_j| 1.5e-7 / r summed over all those pairs
    once.  Both are 0 under the reaction field."""
    n = arrays["charge"].shape[0]
    if arrays["cfg"].mode != cuda_direct.MODE_EWALD:
        return np.zeros((n, 1)), 0.0
    pos, box, q = arrays["wrapped"], arrays["box"], np.abs(arrays["charge"])
    cutoff = arrays["cfg"].cutoff
    excluded = np.zeros((n, n), dtype=bool)
    pairs = arrays["exclusion_pairs"]
    excluded[pairs[:, 0], pairs[:, 1]] = excluded[pairs[:, 1], pairs[:, 0]] = True
    force = np.zeros((n, 1))
    energy = 0.0
    for i0 in range(0, n, 512):
        d = pos[i0:i0 + 512, None, :] - pos[None, :, :]
        for axis in (2, 1, 0):
            d -= np.floor(d[..., axis] / box[axis, axis] + 0.5)[..., None] * box[axis]
        r2 = np.sum(d * d, axis=-1)
        rows = np.arange(i0, min(i0 + 512, n))
        counted = (r2 < cutoff * cutoff) | excluded[rows]
        counted[np.arange(len(rows)), rows] = False
        w = np.where(counted, 1.5e-7 * ONE_4PI_EPS0 * q[rows, None] * q[None, :],
                     0.0)
        r2 = np.where(counted, r2, 1.0)
        force[rows, 0] = np.sum(w / r2, axis=1)
        energy += 0.5 * np.sum(w / np.sqrt(r2))
    return force, energy


def half_box_arrays():
    """The ``grid_3x4x5`` case with every fourth atom moved to half a box
    length (exactly, one float32 step either side, and 1e-6 nm either side)
    from the atom before it along x, y or z, and up to 0.1 nm along the
    other axes (0.1 nm or more from any atom): there the cell kernel's
    cheap minimum image may choose another image than the exact sequence,
    and both must reject the pair."""
    arrays = dict(pair_case_arrays("grid_3x4x5"))
    raw = arrays["raw"].astype(np.float32)
    lengths = np.diag(arrays["box"]).astype(np.float32)
    rng = np.random.default_rng(77)
    for m, b in enumerate(range(3, raw.shape[0], 4)):
        axis = m % 3
        half = np.float32(0.5) * lengths[axis]
        target = [half, np.nextafter(half, np.float32(9)),
                  np.nextafter(half, np.float32(0)), half + np.float32(1e-6),
                  half - np.float32(1e-6)][(m // 3) % 5]
        while True:     # keep 0.1 nm from every other atom
            delta = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
            delta[axis] = target if (m // 15) % 2 else -target
            raw[b] = raw[b - 1] + delta
            d = np.delete(raw, b, axis=0) - raw[b]
            d -= lengths * np.round(d / lengths)
            if np.min(np.sum(d * d, axis=1)) > 0.01:
                break
    arrays["raw"] = raw.astype(np.float64)
    frac = arrays["raw"] @ np.linalg.inv(arrays["box"])
    arrays["wrapped"] = (frac - np.floor(frac)) @ arrays["box"]
    # the moved atoms have left their groups: no exclusions in this case
    arrays["exclusion_list"] = np.full_like(arrays["exclusion_list"], -1)
    arrays["exclusion_pairs"] = np.zeros((0, 2), dtype=np.int64)
    return arrays
