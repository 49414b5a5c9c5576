"""The decompositions of the whole-grid interpolation kernel
(``csrc/pme_interp.cu``) and the fold kernel (``csrc/pme_fold.cu``), written
out on the CPU in plain torch and held to the plain twins.

Interpolation: an atom's 5 z points of a stencil line lie in the chunks of
kVec floats that start at its base rounded down to kVec (kVec 4 where nz is
a multiple of 4, 2 where it is even, else 1), read against weights that are
zero off the 5 points; two threads (in two warps) take one atom and split
its 25 (x, y) lines, numbered x plane by x plane (role 0 lines 0-12, role 1
lines 13-24), each summing its lines in order, and role 0 adds role 1's
shares.  The model
below does the same in float64 and must give ``pme_interp_plain``'s forces
to 1e-12 of (max|F| + 1): for the hard shapes of
``tests/torch_spread_cases.py`` (atoms drifted half the skin towards every
face, one across the box face; a triclinic box; grids of 27, 28, 30 and 32
points along z, so every chunk width), whose grid bases wrap at the box
faces.  In float32 it stays within the 2e-5 of (max|F| + 1) that the CUDA
kernel is held to against the twin.

Fold: a warp owns one output line (s, gx, gy, 0:nz) and stages the window
rows W[Bx, By, Bz, s, ux, uy, 0:wz] of its <= 4 (dx, dy) pieces for every
brick along z, then adds each output point's <= 8 pieces in the order of the
TPU kernel (x outermost, the brick's own piece first).  The model stages
the same rows, shows that every window element is staged by exactly one
line, and must give ``pme_fold_plain``'s grid to the bit, at layouts whose
p differs per axis and reaches w = 2p, one brick along z, nsub 1 to 3; one
layout is also held to the interpret-mode Pallas fold kernel to the bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonbondedslicing_tpu.ops import pallas_pme

from nonbondedslicing_tpu_torch.ops import cuda_pme
from nonbondedslicing_tpu_torch.ops import pme as tpme

from torch_spread_cases import (FOLD_LAYOUTS, SPREAD_CASES, fold_windows,
                                potential_grids, spread_case_slots)

torch.set_num_threads(2)

ORDER = cuda_pme.PME_ORDER


# the (x, y) lines l = 5 a + b that each of an atom's two threads reads, in
# order
ROLE_LINES = (range(0, 13), range(13, 25))


def chunking(nz):
    """(kVec, chunks) of the kernel for a grid of nz points along z."""
    vec = 4 if nz % 4 == 0 else 2 if nz % 2 == 0 else 1
    return vec, 1 + (ORDER - 1 + vec - 1) // vec


def test_lanes_split_the_planes_once():
    """The two roles read every (x, y) line of an atom once, in halves of
    13 and 12 lines."""
    assert sorted(l for lines in ROLE_LINES for l in lines) == list(
        range(ORDER * ORDER))
    assert [len(lines) for lines in ROLE_LINES] == [13, 12]


@pytest.mark.parametrize("nz", [27, 28, 30, 32])
def test_chunk_weights_cover_the_five_points_once(nz):
    """Element i of chunk c holds point c*kVec + i - o (o = base mod kVec):
    the chunks cover the 5 points once whatever o is."""
    vec, chunks = chunking(nz)
    for o in range(vec):
        points = [c * vec + i - o for c in range(chunks) for i in range(vec)]
        assert sorted(p for p in points if 0 <= p < ORDER) == list(
            range(ORDER))
        assert chunks * vec - o >= ORDER


def _wrapped(i, n):
    """i wrapped by one compare and subtraction, as the kernel."""
    return torch.where(i >= n, i - n, i)


def interp_by_lanes(phi, slot_pos, slot_q, slot_sub, recip):
    """The kernel's split of an atom's lines in plain torch: forces
    (g, 3, C)."""
    nsub, nx, ny, nz = phi.shape
    vec, chunks = chunking(nz)
    n = torch.as_tensor((nx, ny, nz), dtype=slot_pos.dtype)
    pos = slot_pos.transpose(1, 2).reshape(-1, 3)
    f = pos @ recip
    t = (f - torch.floor(f)) * n
    ti = torch.floor(t)
    theta, dtheta = tpme.bsplines(t - ti, ORDER)           # (M, 3, order)
    base = _wrapped(ti.long(), torch.as_tensor((nx, ny, nz)))
    bx, by, bz = base.unbind(1)
    o = bz % vec
    # the span of chunks and the weight of each element (0 off the points)
    span = torch.arange(chunks * vec)
    zidx = _wrapped(bz[:, None] - o[:, None] + (span // vec) * vec, nz) \
        + span % vec
    point = span[None, :] - o[:, None]
    on = (point >= 0) & (point < ORDER)
    w = torch.where(on, theta[:, 2].gather(1, point.clamp(0, ORDER - 1)), 0.0)
    dw = torch.where(on, dtheta[:, 2].gather(1, point.clamp(0, ORDER - 1)),
                     0.0)
    grid = phi.reshape(-1)
    sub = slot_sub.reshape(-1).long()
    shares = []
    for lines in ROLE_LINES:
        g = torch.zeros(pos.shape[0], 3, dtype=pos.dtype)
        for line in lines:
            a, b = divmod(line, ORDER)
            row = ((sub * nx + _wrapped(bx + a, nx)) * ny
                   + _wrapped(by + b, ny)) * nz
            e = grid[row[:, None] + zidx]
            v = torch.zeros_like(e[:, 0])
            vd = torch.zeros_like(e[:, 0])
            for i in range(chunks * vec):
                v = v + e[:, i] * w[:, i]
                vd = vd + e[:, i] * dw[:, i]
            tx, dx = theta[:, 0, a], dtheta[:, 0, a]
            ty, dy = theta[:, 1, b], dtheta[:, 1, b]
            g = g + torch.stack([dx * ty * v, tx * dy * v, tx * ty * vd], 1)
        shares.append(g)
    g = shares[0] + shares[1]                 # role 0's sums, then role 1's
    fx, fy, fz = g[:, 0] * nx, g[:, 1] * ny, g[:, 2] * nz
    q = slot_q.reshape(-1)
    out = torch.stack([
        -q * (fx * recip[0, 0]),
        -q * (fx * recip[1, 0] + fy * recip[1, 1]),
        -q * (fx * recip[2, 0] + fy * recip[2, 1] + fz * recip[2, 2])], 1)
    out = torch.where((q == 0)[:, None], torch.zeros_like(out), out)
    g_, _, C = slot_pos.shape
    return out.reshape(g_, C, 3).transpose(1, 2).contiguous()


@pytest.mark.parametrize("case", sorted(SPREAD_CASES))
def test_interp_lane_split_equals_plain_interp(case):
    s = spread_case_slots(case)
    phi = potential_grids(s)
    for weight in (s["q"], 0.05 * s["q"].abs()):          # charges, C6-like
        args = (phi, s["pos"], weight, s["sub"], s["recip"])
        plain = cuda_pme.pme_interp_plain(*args)
        lanes = interp_by_lanes(*args)
        scale = float(plain.abs().max()) + 1.0
        assert float(plain.abs().max()) > 0.1
        assert float((lanes - plain).abs().max()) <= 1e-12 * scale
        # in float32 the reordered sums stay within the kernel's tolerance
        args32 = tuple(a.float() if a.is_floating_point() else a
                       for a in args)
        err = float((interp_by_lanes(*args32)
                     - cuda_pme.pme_interp_plain(*args32)).abs().max())
        assert err <= 2e-5 * scale


def test_interp_lane_split_reads_wrapped_points():
    """The drift case puts stencils across the box faces: some atoms' lines
    wrap on every axis, so the model's compare-and-subtract is exercised."""
    s = spread_case_slots("drift")
    n = torch.as_tensor(s["grid"], dtype=torch.float64)
    f = s["pos"].transpose(1, 2).reshape(-1, 3) @ s["recip"]
    base = torch.floor((f - torch.floor(f)) * n)
    real = s["q"].reshape(-1) != 0
    assert bool(((base[real] + ORDER - 1) >= n).any(dim=0).all())


def fold_by_lines(W):
    """The kernel's line ownership in plain torch: the +1-shifted grids
    (nsub, nx, ny, nz), and for every staged element the flat index of the
    window element it was copied from (-1 where a piece is absent)."""
    bricks, nsub, (wx, wy, wz), (px, py, pz), grid = \
        cuda_pme._window_shapes(W)
    bx, by, bz = bricks
    nx, ny, nz = grid
    # per-axis tables: brick and offset of each output point
    gx, gy = torch.arange(nx), torch.arange(ny)
    X, Y = gx // px, gy // py
    x, y = gx - X * px, gy - Y * py
    flat = torch.arange(W.numel()).reshape(W.shape)
    stages, sources, present = [], [], []
    for dx in (0, 1):
        Bx, ux = (X - dx) % bx, torch.clamp(x + dx * px, max=wx - 1)
        has_x = (x < wx - px) if dx else torch.ones(nx, dtype=torch.bool)
        for dy in (0, 1):
            By, uy = (Y - dy) % by, torch.clamp(y + dy * py, max=wy - 1)
            has_y = (y < wy - py) if dy else torch.ones(ny, dtype=torch.bool)
            idx = (Bx[:, None, None], By[None, :, None],
                   torch.arange(bz)[None, None, :], slice(None),
                   ux[:, None, None], uy[None, :, None])
            # (nx, ny, bz, nsub, wz) -> one line's rows: (nsub, nx, ny, bz*wz)
            rows = W[idx].permute(3, 0, 1, 2, 4).reshape(nsub, nx, ny, -1)
            src = flat[idx].permute(3, 0, 1, 2, 4).reshape(nsub, nx, ny, -1)
            has = (has_x[:, None] & has_y[None, :])[None, :, :, None]
            stages.append(rows)
            sources.append(torch.where(has, src, -1))
            present.append(has)
    gz = torch.arange(nz)
    Z = gz // pz
    z = gz - Z * pz
    own = Z * wz + z
    two_z = z < wz - pz
    before = torch.where(two_z, ((Z - 1) % bz) * wz + z + pz, own)
    acc = None
    for st, has in zip(stages, present):
        for piece, where in ((st[..., own], has),
                             (st[..., before], has & two_z)):
            acc = piece if acc is None else torch.where(where, acc + piece,
                                                        acc)
    return acc, torch.stack(sources)


@pytest.mark.parametrize("layout", sorted(FOLD_LAYOUTS))
def test_fold_lines_equal_plain_fold(layout):
    W = fold_windows(layout)
    grid, sources = fold_by_lines(W)
    assert torch.equal(grid, cuda_pme.pme_fold_plain(W))
    # every window element is staged once, by the one line it lands on
    staged = sources[sources >= 0]
    assert staged.numel() == W.numel()
    assert torch.equal(torch.sort(staged).values, torch.arange(W.numel()))


def test_fold_lines_equal_pallas_fold_kernel():
    layout = "w2p_x"
    bricks, grid_shape, nsub = FOLD_LAYOUTS[layout]
    W = fold_windows(layout)
    fold_j = pallas_pme.make_fold_kernel(grid_shape=grid_shape,
                                         bricks=bricks, nsub=nsub,
                                         interpret=True)
    np.testing.assert_array_equal(fold_by_lines(W)[0].numpy(),
                                  np.asarray(fold_j(jnp.asarray(W.numpy()))))
