"""The port's fixed-order scatter: incidence tables against numpy's
unbuffered ``np.add.at`` (CPU, small random indices)."""

import numpy as np
import pytest
import torch

from nonbondedslicing_tpu_torch.ops import bonded
from nonbondedslicing_tpu_torch.utils.indexing import (incidence_sums,
                                                       incidence_table,
                                                       pair_incidence)


def _scatter(index, values, n, keep=None):
    out = np.zeros((n,) + values.shape[1:])
    live = np.ones(len(index), bool) if keep is None else keep
    np.add.at(out, index[live], values[live])
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_incidence_sums_equal_scatter_add(masked):
    rng = np.random.default_rng(7)
    n = 50
    index = rng.integers(0, 30, 200)        # atoms 30..49 named by none
    values = rng.normal(size=(200, 3))
    keep = rng.random(200) < 0.7 if masked else None
    targets, table = incidence_table(index, n, keep=keep)
    named = np.unique(index if keep is None else index[keep])
    np.testing.assert_array_equal(targets, named)
    sums = incidence_sums(torch.as_tensor(values),
                          torch.as_tensor(table)).numpy()
    want = _scatter(index, values, n, keep)
    np.testing.assert_allclose(sums, want[targets], rtol=0, atol=1e-12)
    others = np.setdiff1d(np.arange(n), targets)
    assert not want[others].any()


def test_pair_incidence_follows_writes_to_its_tensor():
    """The table of a pair tensor is built once and reused while the tensor
    is not written; a write in place rebuilds it."""
    rng = np.random.default_rng(8)
    pairs = torch.as_tensor(rng.integers(0, 20, (40, 2)))
    first = pair_incidence(pairs, 20)
    assert pair_incidence(pairs, 20) is first
    pairs[0] = torch.tensor([19, 18])
    second = pair_incidence(pairs, 20)
    assert second is not first
    f = torch.as_tensor(rng.normal(size=(40, 3)))
    got = bonded._pair_sums(pairs, f, 20).numpy()
    p = pairs.numpy()
    want = _scatter(np.concatenate([p[:, 0], p[:, 1]]),
                    np.concatenate([f.numpy(), -f.numpy()]), 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
