"""The least time of the pair stage: the physical pairs within the cutoff
(each counted once, exceptions left out) at the run's positions, times
the operations ``pair_ops.json`` counts for one pair, over the card's
float32 peak (``peaks.json``), once per launch of a pair kernel.  It does
not depend on how the program stores or pads its pairs."""

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def _json(name):
    with open(os.path.join(HERE, name)) as fh:
        return json.load(fh)


def ops_per_pair():
    table = _json("pair_ops.json")
    total = sum(table["per_pair"].values())
    if total != table["total"]:
        raise ValueError("pair_ops.json: the items do not sum to the total")
    return total


def least_seconds(pairs, launches):
    """Seconds ``launches`` evaluations of ``pairs`` pairs take at the
    float32 peak."""
    return pairs * ops_per_pair() * launches / _json("peaks.json")[
        "fp32_flops_per_s"]
