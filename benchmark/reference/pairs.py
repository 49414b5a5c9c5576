"""Pairs of atoms within a distance, under the minimum image of a
rectangular periodic box, by blocks of rows against every atom."""

import torch

ROW_BLOCK = 1024


def min_image(d, box):
    return d - box * torch.round(d / box)


def find_pairs(pos, box, reach, excluded_keys=None, block=ROW_BLOCK):
    """(i, j) int64 with i < j of the atoms of ``pos`` (N, 3) within
    ``reach`` of each other (minimum image in the box edges ``box`` (3,)),
    leaving out the pairs whose key i * N + j is in the sorted
    ``excluded_keys``.  The search runs in float32 with a margin of 1e-4
    nm; callers keep a pair by its distance in their own precision."""
    n = pos.shape[0]
    p32 = pos.to(torch.float32)
    b32 = box.to(device=pos.device, dtype=torch.float32)
    reach2 = float(reach + 1e-4) ** 2
    cols = torch.arange(n, device=pos.device)
    out_i, out_j = [], []
    for a in range(0, n, block):
        b = min(n, a + block)
        d = min_image(p32[None, :, :] - p32[a:b, None, :], b32)
        r2 = torch.sum(d * d, dim=-1)
        rows = torch.arange(a, b, device=pos.device)
        near = (r2 <= reach2) & (cols[None, :] > rows[:, None])
        i, j = torch.nonzero(near, as_tuple=True)
        out_i.append(i + a)
        out_j.append(j)
    i = torch.cat(out_i)
    j = torch.cat(out_j)
    if excluded_keys is not None and len(excluded_keys):
        keep = ~torch.isin(i * n + j, excluded_keys)
        i, j = i[keep], j[keep]
    return i, j


def count_within(pos, box, cutoff, excluded_keys=None):
    """The number of distinct pairs within ``cutoff`` (float64 distances),
    leaving out the excluded pairs: the pairs a cutoff scheme computes."""
    pos = pos.to(torch.float64)
    box = box.to(device=pos.device, dtype=torch.float64)
    i, j = find_pairs(pos, box, cutoff, excluded_keys)
    d = min_image(pos[j] - pos[i], box)
    return int(torch.count_nonzero(torch.sum(d * d, dim=-1) < cutoff ** 2))
