"""Tracing and timing harness (the JAX package's ``runtime/profiling.py``).

``trace`` records a ``torch.profiler`` trace of the host and, on a machine
with a CUDA device, of the card, written as a Chrome trace (viewable in
Perfetto or chrome://tracing); ``time_fn`` times a function with CUDA
events when its result lies on a CUDA device, else with the host's clock.

Inside the program, ``span(name)`` marks where ``Context.step``,
``Context.getState`` and the engines spend host time and wait on the card,
and ``count(name, n)`` counts rare events (graph captures, retries, bytes
copied between host and device).  Spans are recorded exactly while a
``torch.profiler`` runs (``trace``, or any other profiler session): each
is a plain host event on the profiler's timeline, on the clock of the
card's kernels, with no mark on the device's timeline, and a
:class:`Record` in a bounded list that ``spans()`` returns.  A new
profiler session starts a new list: ``trace`` starts one, and so does the
first span under a profiler after a span that ran with none.  With no
profiler running a span is one flag check and records nothing.  Counters
are always on; ``counters()`` reads them together with the kernel
wrappers' launch counters.  Spans nest on one thread: the program's calls
run on the thread that makes them.
"""

import contextlib
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

# records a profiler session keeps; later spans are counted as dropped
MAX_RECORDS = 65536

_NULL = contextlib.nullcontext()
_records = []        # the session's Records, in the order they opened
_open = []           # the Records open now, innermost last
_counters = {}       # name -> count, process-wide
_session = {"on": False, "calls": 0}


class Record:
    """One span of a profiled session: its ``name``, the ``parent`` Record
    (None at the top level), ``call`` (the number of the top-level call it
    belongs to, from 1 in each session), ``start_ns`` and ``end_ns``
    (``time.perf_counter_ns``; ``end_ns`` None while open) and ``counts``
    (the counters counted while it was the innermost open span).  It is
    the context manager that :func:`span` returns under a profiler."""

    __slots__ = ("name", "parent", "call", "start_ns", "end_ns", "counts",
                 "_mark")

    def __init__(self, name):
        self.name = name
        self.end_ns = None
        self.counts = {}

    def __enter__(self):
        parent = _open[-1] if _open else None
        if parent is None:
            _session["calls"] += 1
            self.call = _session["calls"]
        else:
            self.call = parent.call
        self.parent = parent
        if len(_records) < MAX_RECORDS:
            _records.append(self)
        else:
            _counters["spans.dropped"] = _counters.get("spans.dropped", 0) + 1
        _open.append(self)
        self._mark = _RecordFunctionFast(self.name)
        self._mark.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        self._mark.__exit__(*exc)
        _open.pop()
        return False


def _new_session():
    _records.clear()
    _session["calls"] = 0
    _session["on"] = True


def span(name):
    """A context manager around one stage of the program.  While a
    ``torch.profiler`` runs it records a host event ``name`` on the
    profiler's timeline (``torch._C._profiler._RecordFunctionFast``: not a
    user annotation, so the device's timeline shows nothing of it) and a
    :class:`Record`; the first span of a new profiler session clears the
    records of the last.  Otherwise it returns one shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        _session["on"] = False
        return _NULL
    if not _session["on"]:
        _new_session()
    return Record(name)


def spans():
    """The Records of the current or last profiler session, in the order
    they opened (at most :data:`MAX_RECORDS`; the counter
    ``spans.dropped`` counts the rest)."""
    return list(_records)


def count(name, n=1):
    """Add ``n`` to the counter ``name``; while a span is open, credit it
    to the innermost one's ``counts`` too."""
    _counters[name] = _counters.get(name, 0) + n
    if _open:
        counts = _open[-1].counts
        counts[name] = counts.get(name, 0) + n


def counters():
    """Every counter of the process: those of :func:`count` (``graph.*``,
    ``md.retries``, ``eval.capacity_grows``, ``bus.h2d_bytes``,
    ``bus.d2h_bytes``, ``spans.dropped``) and the kernel wrappers'
    launches as ``launch.<kernel>`` (``ops.cuda_direct.LAUNCHES``,
    ``ops.cuda_pme.LAUNCHES``, ``runtime.water_tail.LAUNCHES``)."""
    from ..ops import cuda_direct, cuda_pme
    from . import water_tail
    out = dict(_counters)
    for launches in (cuda_direct.LAUNCHES, cuda_pme.LAUNCHES,
                     water_tail.LAUNCHES):
        out.update(("launch." + name, n) for name, n in launches.items())
    return out


def to_device(x, device):
    """``torch.as_tensor(x, device=device)``.  Host data (anything but a
    tensor already on ``device``) is counted in ``bus.h2d_bytes`` by the
    size of the tensor made; on a CPU device these are the same points,
    though no bus is crossed."""
    out = torch.as_tensor(x, device=device)
    if not torch.is_tensor(x) or x.device != out.device:
        count("bus.h2d_bytes", out.nbytes)
    return out


def to_host(t, dtype=torch.float64):
    """``t`` as a numpy array of ``dtype``, its bytes counted in
    ``bus.d2h_bytes``."""
    out = t.to("cpu", dtype).numpy()
    count("bus.d2h_bytes", out.nbytes)
    return out


def to_list(t):
    """``t.tolist()``, the tensor's bytes counted in ``bus.d2h_bytes``."""
    count("bus.d2h_bytes", t.nbytes)
    return t.tolist()


@contextlib.contextmanager
def trace(log_dir):
    """Record the enclosed work with ``torch.profiler`` (CPU activity, and
    CUDA activity where a device is present) and write it to
    ``log_dir/trace.json``.  Yields the profiler, whose
    ``key_averages()`` sums the time by operator and kernel.  The
    program's spans (:func:`span`) are on while it runs; :func:`spans`
    returns this session's records afterwards."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        _new_session()
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
