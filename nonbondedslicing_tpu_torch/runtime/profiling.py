"""Tracing and timing harness (the JAX package's ``runtime/profiling.py``).

``trace`` records a ``torch.profiler`` trace of the host and, on a machine
with a CUDA device, of the card, written as a Chrome trace (viewable in
Perfetto or chrome://tracing); ``time_fn`` times a function with CUDA
events when its result lies on a CUDA device, else with the host's clock.
"""

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Record the enclosed work with ``torch.profiler`` (CPU activity, and
    CUDA activity where a device is present) and write it to
    ``log_dir/trace.json``.  Yields the profiler, whose
    ``key_averages()`` sums the time by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))


def _first_tensor(out):
    if torch.is_tensor(out):
        return out
    if isinstance(out, (list, tuple)):
        for item in out:
            found = _first_tensor(item)
            if found is not None:
                return found
    if isinstance(out, dict):
        return _first_tensor(list(out.values()))
    return None


def time_fn(fn, *args, warmup=2, reps=10, **kwargs):
    """Median seconds of one ``fn(*args, **kwargs)`` call over ``reps``
    calls, after ``warmup`` calls.  Where ``fn`` returns a tensor on a
    CUDA device each call is timed by CUDA events around it (the device's
    time from the call's launch to its end), else by the host's clock
    around it."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args, **kwargs)
    first = _first_tensor(out)
    on_card = first is not None and first.device.type == "cuda"
    times = []
    for _ in range(reps):
        if on_card:
            torch.cuda.synchronize(first.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1000.0)
        else:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
