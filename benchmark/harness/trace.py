"""The profiled slice of a traced run, and what is read from it.

``Tracer`` runs ``torch.profiler`` (host and device activity) over a fixed
run of samples of the window, with a ``record_function`` span around each
call into the program (``bench.step``, ``bench.getState``).  ``summarize``
turns the profile into plain lists:

* the device's operations (kernels, copies, fills), each with its name,
  its interval and the span it ran in (the program syncs before each call
  returns, so a call's device work lies inside its span);
* the host's launch calls (a kernel or a CUDA graph) inside each span;
* the slice's busy time (the union of the device intervals) and length;
* the longest idle gaps of the device, by what the host was doing then.

The names of the program's hand-written kernels come from its sources:
``__global__`` functions of ``csrc/*.cu`` in the package directory.
"""

import bisect
import os
import re
from collections import defaultdict
from dataclasses import dataclass, field

# the host's calls that put work on the card: one kernel, or one graph
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
SPANS = ("bench.step", "bench.getState")
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


def csrc_kernels(package_dir):
    """{kernel name: source file stem} of the program's ``csrc/*.cu``."""
    out = {}
    csrc = os.path.join(package_dir, "csrc")
    if not os.path.isdir(csrc):
        return out
    for name in sorted(os.listdir(csrc)):
        if name.endswith(".cu"):
            with open(os.path.join(csrc, name)) as fh:
                for kernel in _GLOBAL.findall(fh.read()):
                    out[kernel] = name[:-3]
    return out


def kernel_stem(op_name, kernels):
    """The source stem of the hand-written kernel a device operation's name
    (``void (anonymous namespace)::pair_column_kernel<true>(float
    const*, ...)``) names, or None."""
    for ident in re.findall(r"\w+", op_name):
        if ident in kernels:
            return kernels[ident]
    return None


def is_transfer(name):
    return name.lower().startswith(("memcpy", "memset"))


def union_length(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@dataclass
class DeviceOp:
    name: str
    start_us: float
    end_us: float
    span: str            # the bench span it ran in, or ""
    stem: str = None     # the hand-written kernel's source, or None


@dataclass
class TraceSummary:
    steps: int = 0                     # integrator steps in the slice
    window_us: float = 0.0
    busy_us: float = 0.0
    ops: list = field(default_factory=list)
    launches: dict = field(default_factory=dict)   # span -> host launches
    idle_gaps: list = field(default_factory=list)  # (label, seconds)

    def device_ops(self, top=10):
        """The device operations that took most time, as (name, seconds)."""
        by_name = defaultdict(float)
        for op in self.ops:
            by_name[op.name] += op.end_us - op.start_us
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:200], us * 1e-6] for name, us in ranked]


class Tracer:
    """Profiles the samples first .. first + count - 1 of the window."""

    def __init__(self, torch, first, count, steps_per_sample, cuda=True):
        self.torch = torch
        self.cuda = cuda
        self.first = first
        self.count = count
        self.steps_per_sample = steps_per_sample
        self.prof = None
        self.done = False

    def active(self, index):
        return self.first <= index < self.first + self.count

    def sample(self, index):
        tracer = self

        class _Scope:
            def __enter__(self):
                if index == tracer.first:
                    prof_mod = tracer.torch.profiler
                    kinds = [prof_mod.ProfilerActivity.CPU]
                    if tracer.cuda:
                        kinds.append(prof_mod.ProfilerActivity.CUDA)
                    tracer.prof = prof_mod.profile(activities=kinds)
                    tracer.prof.__enter__()

            def __exit__(self, *exc):
                if index == tracer.first + tracer.count - 1 \
                        and tracer.prof is not None:
                    if tracer.cuda:
                        tracer.torch.cuda.synchronize()
                    tracer.prof.__exit__(*exc)
                    tracer.done = True
                return False

        return _Scope()

    def span(self, name):
        return self.torch.profiler.record_function(name)

    def close(self, samples):
        """Ends a slice that the window's end cut short; the summary then
        covers the ``samples`` - first samples profiled."""
        if self.prof is not None and not self.done:
            if self.cuda:
                self.torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.count = max(0, samples - self.first)
            self.done = True

    def summarize(self, kernels):
        """A :class:`TraceSummary` of the slice, or None if the window
        ended before the slice did."""
        if not self.done:
            return None
        torch = self.torch
        cpu, dev = [], []
        for ev in self.prof.events():
            rng = ev.time_range
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((rng.start, rng.end, ev.name))
            else:
                cpu.append((rng.start, rng.end, ev.name, ev.thread))
        self.prof = None
        spans = sorted((s, e, n) for s, e, n, _ in cpu if n in SPANS)
        out = TraceSummary(steps=self.count * self.steps_per_sample)
        if not spans:
            return out
        main = next(t for s, e, n, t in cpu if n in SPANS)
        lo, hi = spans[0][0], spans[-1][1]
        out.window_us = hi - lo
        starts = [s for s, _, _ in spans]

        def span_of(t):
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and spans[k][0] <= t <= spans[k][1]:
                return spans[k][2]
            return ""

        for s, e, name in dev:
            # the spans' own marks on the device's timeline are no work
            if e < lo or s > hi or name in SPANS:
                continue
            out.ops.append(DeviceOp(name, s, e, span_of(s),
                                    kernel_stem(name, kernels)))
        out.busy_us = union_length(
            [(max(op.start_us, lo), min(op.end_us, hi)) for op in out.ops])
        out.launches = {n: 0 for n in SPANS}
        for s, e, name, thread in cpu:
            if name in HOST_LAUNCHES:
                where = span_of(s)
                if where:
                    out.launches[where] += 1
        out.idle_gaps = _idle_gaps(out.ops, lo, hi,
                                   [c for c in cpu if c[3] == main])
        return out


def _idle_gaps(ops, lo, hi, cpu, top=10, min_us=5.0):
    """The device's idle time in [lo, hi], by the innermost host event
    open at each gap's start (one thread's events nest), largest first,
    as (label, seconds)."""
    intervals = sorted((op.start_us, op.end_us) for op in ops)
    gaps, end = [], lo
    for s, e in intervals:
        if s - end >= min_us:
            gaps.append((end, s))
        end = max(end, e)
    if hi - end >= min_us:
        gaps.append((end, hi))
    events = sorted(cpu, key=lambda c: (c[0], -c[1]))
    totals = defaultdict(float)
    stack, k = [], 0
    for g0, g1 in gaps:
        while k < len(events) and events[k][0] <= g0:
            while stack and stack[-1][1] < events[k][0]:
                stack.pop()
            stack.append(events[k])
            k += 1
        while stack and stack[-1][1] < g0:
            stack.pop()
        outer = next((c[2] for c in stack if c[2] in SPANS), "client")
        inner = stack[-1][2] if stack else "client"
        label = outer if inner == outer else f"{outer} > {inner}"
        totals[label[:200]] += (g1 - g0) * 1e-6
    return [[k_, v] for k_, v in sorted(totals.items(),
                                        key=lambda kv: -kv[1])[:top]]
