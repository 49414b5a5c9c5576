"""sample_p95_ms.host: the 95th percentile, over every sample of the window
outside the profiled slice, of one sample's wall time (its steps, getState,
the client's reduced energies and checkpoint), host clock.  It swings with
the host's speed from process to process, so it is read per layer and
bounds nothing."""

import numpy as np


def read(run):
    times = [s.total_s for s in run.samples if not s.profiled]
    if len(times) < 20:
        return None
    return float(np.percentile(times, 95)) * 1e3
