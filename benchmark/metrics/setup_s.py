"""setup_s: from the start of the process to the start of the window:
imports, the system, the Context, the kernels' build where it is not
cached, the warm-up sample (graph captures) (host clock)."""


def read(run):
    return run.setup_s
