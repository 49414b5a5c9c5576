"""torch_kernels_ms: device ms per step, inside the integrator.step spans
of the profiled slice, of every kernel not built from the program's
csrc/ (PyTorch's own, cuFFT, cuBLAS); copies and fills left out."""

from harness.trace import is_transfer


def read(run):
    trace = run.trace
    if trace is None or not trace.steps or not trace.ops:
        return None
    us = sum(op.end_us - op.start_us for op in trace.ops
             if op.span == "bench.step" and op.stem is None
             and not is_transfer(op.name))
    return us * 1e-3 / trace.steps
