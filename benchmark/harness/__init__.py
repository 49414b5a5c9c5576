"""The benchmark's harness: the cells found by name (``catalog``), the
inputs (``spec``, ``systems``), the closed-loop client (``client``), the
profiled slice (``trace``), the comparison with the reference (``check``)
and the run's guards (``guard``)."""
