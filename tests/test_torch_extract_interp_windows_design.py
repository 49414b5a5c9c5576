"""The decompositions of the extract kernel (``csrc/pme_extract.cu``) and
the window interpolation kernel (``csrc/pme_interp_windows.cu``), written
out on the CPU in plain torch and held to the plain twins.

Extract: a block owns one window (brick, subset) and writes it whole,
thread (c, uy, ux) of its (tx, ty, tz) threads the chunk of kOut floats c
of row (ux, uy) (kOut 4 where wz is a multiple of 4, 2 where it is even,
else 1), for c, uy and ux in steps of the block's extent; a chunk's grid
points are (X*px + ux, Y*py + uy, Z*pz + uz + k), each wrapped by one
compare.  The model walks the same threads and steps, shows that every
window element is written exactly once, by a block of at most 256
threads, and comes from its grid point ((b*p + u) mod n on each axis), and
must give ``pme_extract_plain``'s windows to the bit at layouts whose p
differs per axis and reaches w = 2p, one brick along z, nsub 1 to 3, rows
of 12 to 15 points, for every chunk width a layout admits; one layout is also held to the
interpret-mode Pallas extract kernel to the bit.

Window interpolation: B3's design (tests/test_torch_interp_fold_design.py)
on windows.  Two threads (in two warps) take one atom and split its 25
(x, y) lines, role 0 lines 0-12 and role 1 lines 13-24, each summing its
lines in order, and role 0 adds role 1's shares; a line's 5 z points are
read as the aligned chunks of kVec floats that hold them (kVec 4 where wz
is a multiple of 4, 2 where it is even, else 1) against weights zero off
the points.  A window has edges: the first row rel = (base - (B*p - 1))
mod n is formed by compares, a line whose x or y row is at or past the
width is not read, nor is a z chunk that starts at or past it.  The model
asserts that every element it reads lies in its own row of its own window,
and must give ``pme_interp_windows_plain``'s forces to 1e-12 of
(max|F| + 1) in float64 and within the kernel's 2e-5 in float32, at
windows of 13, 14 and 16 points along z (so every chunk width) whose atoms
drift far enough that rows reach past the window, and at brick-major
spread cases (one of them one brick along y and z).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonbondedslicing_tpu.ops import pallas_pme

from nonbondedslicing_tpu_torch.ops import cuda_pme
from nonbondedslicing_tpu_torch.ops import pme as tpme
from nonbondedslicing_tpu_torch.ops import pme_bricks as tbricks

from torch_spread_cases import (EXTRACT_LAYOUTS, WIDTH_CASES,
                                WINDOW_INTERP_CASES, layout_grids,
                                potential_windows, spread_case_slots,
                                window_bricks)

torch.set_num_threads(2)

ORDER = cuda_pme.PME_ORDER
# the (x, y) lines l = 5 a + b that each of an atom's two threads reads, in
# order
ROLE_LINES = (range(0, 13), range(13, 25))


# ------------------------------------------------------------------ extract

def extract_block(w, k_out):
    """(tx, ty, tz) threads of the kernel's block for windows of w = (wx,
    wy, wz) points, as its launch chooses them."""
    chunks = w[2] // k_out
    tx = min(chunks, 32)
    ty = min(w[1], 256 // tx)
    tz = min(w[0], 256 // (tx * ty))
    return tx, ty, tz


def _steps(extent, n):
    """Thread t of ``extent`` visits t, t + extent, ... below n: the
    visits (thread, index) of a strided loop."""
    t = torch.arange(extent)
    i = torch.arange((n + extent - 1) // extent)
    u = (t[:, None] + i[None, :] * extent).reshape(-1)
    return u[u < n]


def extract_by_windows(grid, bricks, k_out):
    """The kernel's window ownership in plain torch: the windows
    (bx, by, bz, nsub, wx, wy, wz), how often each window element was
    written, and the flat grid index each was copied from."""
    nsub, nx, ny, nz = grid.shape
    (px, wx), (py, wy), (pz, wz) = tbricks.brick_window((nx, ny, nz), bricks)
    bx, by, bz = bricks
    tx, ty, tz = extract_block((wx, wy, wz), k_out)
    assert tx * ty * tz <= 256 and wz % k_out == 0
    # what the threads visit: chunk starts along z, rows uy, planes ux
    uz = (_steps(tx, wz // k_out) * k_out)[:, None] + torch.arange(k_out)
    uy, ux = _steps(ty, wy), _steps(tz, wx)
    # the blocks: (X * nsub + s, Y, Z)
    XS = torch.arange(bx * nsub)
    X, s = XS // nsub, XS % nsub
    Y, Z = torch.arange(by), torch.arange(bz)

    def wrap(i, n):
        return torch.where(i >= n, i - n, i)

    # (X*nsub + s, Y, Z, ux, uy, uz chunk, k)
    shape = (bx * nsub, by, bz, ux.numel(), uy.numel()) + tuple(uz.shape)
    gx = wrap(X[:, None] * px + ux[None, :], nx)[:, None, None, :, None,
                                                 None, None]
    gy = wrap(Y[:, None] * py + uy[None, :], ny)[None, :, None, None, :,
                                                 None, None]
    gz = wrap(Z[:, None, None] * pz + uz[None], nz)[None, None, :, None,
                                                    None]
    src = ((s[:, None, None, None, None, None, None] * nx + gx) * ny
           + gy) * nz + gz
    dst = (((((X[:, None, None, None, None, None, None] * by
               + Y[None, :, None, None, None, None, None]) * bz
              + Z[None, None, :, None, None, None, None]) * nsub
             + s[:, None, None, None, None, None, None]) * wx
            + ux[None, None, None, :, None, None, None]) * wy
           + uy[None, None, None, None, :, None, None]) * wz \
        + uz[None, None, None, None, None]
    src, dst = src.expand(shape).reshape(-1), dst.expand(shape).reshape(-1)
    n_w = bx * by * bz * nsub * wx * wy * wz
    W = torch.zeros(n_w, dtype=grid.dtype)
    W[dst] = grid.reshape(-1)[src]
    writes = torch.zeros(n_w, dtype=torch.int64).index_add_(
        0, dst, torch.ones_like(dst))
    source = torch.full((n_w,), -1, dtype=torch.int64)
    source[dst] = src
    out = tuple(bricks) + (nsub, wx, wy, wz)
    return W.reshape(out), writes.reshape(out), source.reshape(out)


def _window_source(grid_shape, bricks, nsub):
    """The grid index of every window element by definition: window point
    u of brick b is grid line (b*p + u) mod n on each axis."""
    lines = []
    for n, b, (p, w) in zip(grid_shape, bricks,
                            tbricks.brick_window(grid_shape, bricks)):
        lines.append((torch.arange(b)[:, None] * p
                      + torch.arange(w)[None, :]) % n)
    ix, iy, iz = lines
    nx, ny, nz = grid_shape
    s = torch.arange(nsub)
    return (((s[None, None, None, :, None, None, None] * nx
              + ix[:, None, None, None, :, None, None]) * ny
             + iy[None, :, None, None, None, :, None]) * nz
            + iz[None, None, :, None, None, None, :])


@pytest.mark.parametrize("layout", sorted(EXTRACT_LAYOUTS))
def test_extract_windows_equal_plain_extract(layout):
    bricks, grid_shape, nsub = EXTRACT_LAYOUTS[layout]
    grid = layout_grids(layout)
    plain = cuda_pme.pme_extract_plain(grid, bricks)
    wz = plain.shape[-1]
    for k_out in (k for k in (4, 2, 1) if wz % k == 0):
        W, writes, source = extract_by_windows(grid, bricks, k_out)
        assert torch.equal(W, plain)
        # every window element written once, from its own grid point
        assert bool((writes == 1).all())
        assert torch.equal(source, _window_source(grid_shape, bricks, nsub))


def test_extract_windows_equal_pallas_extract_kernel():
    layout = "uneven"
    bricks, grid_shape, nsub = EXTRACT_LAYOUTS[layout]
    grid = layout_grids(layout)
    extract_j = pallas_pme.make_extract_kernel(grid_shape=grid_shape,
                                               bricks=bricks, nsub=nsub,
                                               interpret=True)
    W_j = np.asarray(extract_j(jnp.asarray(grid.numpy())))
    np.testing.assert_array_equal(
        extract_by_windows(grid, bricks, 1)[0].numpy().reshape(W_j.shape),
        W_j)


@pytest.mark.parametrize("w", [(12, 12, 12), (16, 16, 16), (13, 14, 15),
                               (40, 41, 41), (24, 30, 140)])
def test_extract_block_covers_any_window(w):
    """The block's threads, stepping by its extent, visit every chunk of
    every row of a window once, with at most 256 threads, for rows of any
    width (more than 32 chunks a row included)."""
    for k_out in (k for k in (4, 2, 1) if w[2] % k == 0):
        tx, ty, tz = extract_block(w, k_out)
        assert 1 <= tx * ty * tz <= 256
        for extent, n in ((tx, w[2] // k_out), (ty, w[1]), (tz, w[0])):
            assert torch.equal(torch.sort(_steps(extent, n)).values,
                               torch.arange(n))


# ------------------------------------------------------ window interpolation

def chunking(wz):
    """(kVec, chunks) of the kernel for windows of wz points along z."""
    vec = 4 if wz % 4 == 0 else 2 if wz % 2 == 0 else 1
    return vec, 1 + (ORDER - 1 + vec - 1) // vec


def _wrapped(i, n):
    """i wrapped by one compare and subtraction, as the kernel."""
    return torch.where(i >= n, i - n, i)


def window_row(base, B, p, n):
    """(base - (B*p - 1)) mod n by compares, as the kernel."""
    r = base - B * p + 1
    return torch.where(r < 0, r + n, _wrapped(r, n))


def test_window_row_by_compares_is_the_modulo():
    for n, p in ((12, 6), (16, 8), (28, 7), (30, 10)):
        base = torch.arange(n)[:, None]
        B = torch.arange(n // p)[None, :]
        assert torch.equal(window_row(base, B, p, n),
                           (base - (B * p - 1)) % n)


def interp_windows_by_roles(W, slot_pos, slot_q, slot_sub, recip):
    """The kernel's split of an atom's lines on windows in plain torch:
    forces (g, 3, C), and the counts of (real atoms, lines skipped, z chunks
    not read).  Asserts that every element read lies in its own row of its
    own window."""
    bricks, nsub, (wx, wy, wz), (px, py, pz), grid = \
        cuda_pme._window_shapes(W)
    nbx, nby, nbz = bricks
    vec, chunks = chunking(wz)
    g, _, C = slot_pos.shape
    brick = torch.arange(g * C) // C
    X = brick // (nbz * nby)
    Y = (brick - X * nbz * nby) // nbz
    Z = brick - X * nbz * nby - Y * nbz
    n = torch.as_tensor(grid, dtype=slot_pos.dtype)
    pos = slot_pos.transpose(1, 2).reshape(-1, 3)
    f = pos @ recip
    t = (f - torch.floor(f)) * n
    ti = torch.floor(t)
    theta, dtheta = tpme.bsplines(t - ti, ORDER)            # (M, 3, order)
    base = _wrapped(ti.long(), torch.as_tensor(grid))
    rx = window_row(base[:, 0], X, px, grid[0])
    ry = window_row(base[:, 1], Y, py, grid[1])
    rz = window_row(base[:, 2], Z, pz, grid[2])
    o = rz % vec
    span = torch.arange(chunks * vec)
    start = rz[:, None] - o[:, None] + (span // vec) * vec   # of i's chunk
    live = start < wz                                         # (M, span)
    point = span[None, :] - o[:, None]
    on = (point >= 0) & (point < ORDER) & live
    pc = point.clamp(0, ORDER - 1)
    w = torch.where(on, theta[:, 2].gather(1, pc), 0.0)
    dw = torch.where(on, dtheta[:, 2].gather(1, pc), 0.0)
    wsize = wx * wy * wz
    win = (brick * nsub + slot_sub.reshape(-1).long()) * wsize
    flat = W.reshape(-1)
    real = slot_q.reshape(-1) != 0
    skipped = 0
    shares = []
    for lines in ROLE_LINES:
        gsum = torch.zeros(pos.shape[0], 3, dtype=pos.dtype)
        for line in lines:
            a, b = divmod(line, ORDER)
            line_live = (rx + a < wx) & (ry + b < wy)
            skipped += int((real & ~line_live).sum())
            row = win + (rx + a) * wy * wz + (ry + b) * wz
            idx = row[:, None] + start + span % vec
            read = real[:, None] & line_live[:, None] & live
            # what is read lies in the atom's own row of its own window
            assert bool((start + span % vec < wz)[read].all())
            assert bool(((idx >= win[:, None])
                         & (idx < (win + wsize)[:, None]))[read].all())
            e = torch.where(read, flat[idx.clamp(0, flat.numel() - 1)], 0.0)
            v = torch.zeros_like(e[:, 0])
            vd = torch.zeros_like(e[:, 0])
            for i in range(chunks * vec):
                v = v + e[:, i] * w[:, i]
                vd = vd + e[:, i] * dw[:, i]
            tx, dx = theta[:, 0, a], dtheta[:, 0, a]
            ty, dy = theta[:, 1, b], dtheta[:, 1, b]
            gsum = gsum + torch.where(
                line_live[:, None],
                torch.stack([dx * ty * v, tx * dy * v, tx * ty * vd], 1),
                0.0)
        shares.append(gsum)
    gsum = shares[0] + shares[1]              # role 0's sums, then role 1's
    fx, fy, fz = gsum[:, 0] * grid[0], gsum[:, 1] * grid[1], \
        gsum[:, 2] * grid[2]
    q = slot_q.reshape(-1)
    out = torch.stack([
        -q * (fx * recip[0, 0]),
        -q * (fx * recip[1, 0] + fy * recip[1, 1]),
        -q * (fx * recip[2, 0] + fy * recip[2, 1] + fz * recip[2, 2])], 1)
    out = torch.where(real[:, None], out, torch.zeros_like(out))
    dead_chunks = int((real[:, None] & ~live).any(dim=1).sum())
    return (out.reshape(g, C, 3).transpose(1, 2).contiguous(),
            (int(real.sum()), skipped, dead_chunks))


def _interp_case(case):
    bricks = window_bricks(case)
    s = spread_case_slots(case, bricks=bricks)
    return s, potential_windows(s, bricks)


@pytest.mark.parametrize("case", WINDOW_INTERP_CASES)
def test_interp_windows_role_split_equals_plain(case):
    s, W = _interp_case(case)
    for weight in (s["q"], 0.05 * s["q"].abs()):          # charges, C6-like
        args = (W, s["pos"], weight, s["sub"], s["recip"])
        plain = cuda_pme.pme_interp_windows_plain(*args)
        roles, _ = interp_windows_by_roles(*args)
        scale = float(plain.abs().max()) + 1.0
        assert float(plain.abs().max()) > 0.1
        assert float((roles - plain).abs().max()) <= 1e-12 * scale
        # in float32 the reordered sums stay within the kernel's tolerance
        args32 = tuple(a.float() if a.is_floating_point() else a
                       for a in args)
        err = float((interp_windows_by_roles(*args32)[0]
                     - cuda_pme.pme_interp_windows_plain(*args32))
                    .abs().max())
        assert err <= 2e-5 * scale


@pytest.mark.parametrize("case", sorted(WIDTH_CASES))
def test_interp_windows_cases_reach_past_the_window(case):
    """The width cases exercise the window's edges: lines whose x or y row
    lies past the width are skipped and z chunks past it are not read, for
    some atoms, while most atoms read all 25 lines."""
    s, W = _interp_case(case)
    _, (n_real, skipped, dead_chunks) = interp_windows_by_roles(
        W, s["pos"], s["q"], s["sub"], s["recip"])
    assert skipped > 0 and dead_chunks > 0
    assert skipped < 25 * n_real // 10
    vec, _ = chunking(W.shape[-1])
    assert vec == {13: 1, 14: 2, 16: 4}[W.shape[-1]]
