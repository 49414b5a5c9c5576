"""``pair_column``'s plain twin over ranges of home cells (the slab step's
launches, ``parallel/fused_shard.make_sharded_md_step``): on every hard
shape of ``tests/torch_pair_cases.py``, the outputs of 2 and 3 ranges
concatenated equal the whole-grid call to the bit, forces and moment
panels alike, in float32 and float64.  The same on the card:
``tests/test_torch_gpu_parallel.py``."""

import functools

import pytest
import torch

from nonbondedslicing_tpu_torch.ops import cuda_direct

from torch_pair_cases import PAIR_CASES, pair_case_arrays, pair_case_slots


@functools.lru_cache(maxsize=None)
def whole_grid(case, dtype):
    """(the slot arguments, n, cfg, the whole-grid forces and panels)."""
    arrays = pair_case_arrays(case)
    args = pair_case_slots(arrays, False, "cpu", dtype)["args"]
    n = arrays["charge"].shape[0]
    return (args, n, arrays["cfg"]) + cuda_direct.pair_column_plain(
        *args, True, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_pair_column_plain_ranges_equal_whole_grid(case, parts, dtype):
    args, n, cfg, f_all, m_all = whole_grid(case, dtype)
    per = -(-cfg.n_cells // parts)
    outs = [cuda_direct.pair_column(*args, True, n,
                                    cells=(lo, min(per, cfg.n_cells - lo)))
            for lo in range(0, cfg.n_cells, per)]
    assert len(outs) == parts
    assert torch.equal(torch.cat([o[0] for o in outs]), f_all)
    assert torch.equal(torch.cat([o[1] for o in outs]), m_all)
    # force-only launches take the range too
    f_only = cuda_direct.pair_column(*args, False, n, cells=(0, per))[0]
    assert torch.equal(f_only, f_all[:per])
    with pytest.raises(ValueError, match="cells"):
        cuda_direct.pair_column(*args, True, n, cells=(cfg.n_cells - 1, 2))
