"""The work counts and the roofline arithmetic, on hand-checked cases."""

import math

import pytest
import torch

from harness.trace import (DeviceOp, TraceSummary, csrc_kernels, kernel_stem,
                           union_length)
from reference.pairs import count_within
from work import pair_roofline_pct as pair_work
from work import pme_roofline_pct as pme_work


def test_pair_operation_count():
    assert pair_work.ops_per_pair() == 59


def test_pair_least_time():
    # 1e6 pairs, 2 launches, 59 operations a pair, 67 TFLOP/s
    assert pair_work.least_seconds(1_000_000, 2) == pytest.approx(
        2 * 59e6 / 67e12)


def test_pme_bytes():
    # 10 atoms, 2 subsets, a 4^3 grid: 10 * 20 + 2 * 64 * 4 bytes spread,
    # 10 * 32 + 2 * 64 * 4 interpolated
    assert pme_work.spread_bytes(10, 2, 64) == 200 + 512
    assert pme_work.interp_bytes(10, 2, 64) == 320 + 512
    assert pme_work.least_seconds(10, 2, 64, 3, 1) == pytest.approx(
        (3 * 712 + 832) / 3.35e12)


def test_pairs_counted_once_under_the_minimum_image():
    box = torch.tensor([3.0, 3.0, 3.0], dtype=torch.float64)
    pos = torch.tensor([[0.1, 0.1, 0.1], [2.9, 0.1, 0.1], [1.5, 1.5, 1.5],
                        [1.5, 1.5, 2.2]], dtype=torch.float64)
    # (0, 1) 0.2 apart across the face, (2, 3) 0.7 apart, the rest far
    assert count_within(pos, box, 0.9) == 2
    excluded = torch.tensor([2 * 4 + 3])
    assert count_within(pos, box, 0.9, excluded) == 1


def test_busy_time_is_a_union():
    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4


def test_kernel_names_come_from_the_sources():
    import nonbondedslicing_tpu_torch as program
    import os
    kernels = csrc_kernels(os.path.dirname(program.__file__))
    assert kernels.get("pair_column_kernel") == "pair_column"
    assert kernel_stem("void (anonymous namespace)::pair_column_kernel<"
                       "false, false, false>(float const*, int)",
                       kernels) == "pair_column"
    assert kernel_stem("void at::native::vectorized_elementwise_kernel<4>"
                       "(int)", kernels) is None


def _run(ops, steps=4, pairs=1000):
    trace = TraceSummary(steps=steps, window_us=1000.0,
                         busy_us=250.0, ops=ops,
                         launches={"bench.step": 8, "bench.getState": 3})
    return type("Run", (), {"trace": trace, "samples": [],
                            "work": {"pairs_within_cutoff": pairs,
                                     "atoms": 10, "subsets": 2,
                                     "grid_points": 64}})


def test_readers_of_a_trace():
    from harness import catalog
    ops = [DeviceOp("pair", 0, 10, "bench.step", "pair_column"),
           DeviceOp("pair", 20, 30, "bench.step", "pair_column"),
           DeviceOp("spread", 30, 31, "bench.step", "pme_spread"),
           DeviceOp("interp", 31, 33, "bench.step", "pme_interp"),
           DeviceOp("mul", 40, 60, "bench.step", None),
           DeviceOp("Memcpy HtoD", 60, 70, "bench.step", None),
           DeviceOp("mul", 80, 90, "bench.getState", None)]
    run = _run(ops)
    assert catalog.reader("launches_per_step")(run) == 2.0
    assert catalog.reader("torch_kernels_ms")(run) == pytest.approx(
        20e-3 / 4)
    assert catalog.reader("device_idle_pct")(run) == 75.0
    pair = catalog.reader("pair_roofline_pct")(run)
    assert pair == pytest.approx(100 * 2 * 1000 * 59 / 67e12 / 20e-6)
    pme = catalog.reader("pme_roofline_pct")(run)
    assert pme == pytest.approx(100 * (712 + 832) / 3.35e12 / 3e-6)
    assert math.isfinite(pme)


def test_readers_without_their_kernels_read_nothing():
    from harness import catalog
    run = _run([DeviceOp("mul", 0, 10, "bench.step", None)])
    assert catalog.reader("pair_roofline_pct")(run) is None
    assert catalog.reader("pme_roofline_pct")(run) is None
    run.trace = None
    for name in ("launches_per_step", "torch_kernels_ms", "device_idle_pct"):
        assert catalog.reader(name)(run) is None
