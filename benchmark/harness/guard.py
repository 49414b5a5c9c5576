"""The checks a run makes of its process and its machine."""

import sys

# top-level module names that may not be loaded in a run: JAX, its
# libraries and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "nonbondedslicing_tpu")


def forbidden_modules(modules=None):
    """The loaded modules whose whole top-level name (before the first
    dot) is in FORBIDDEN; ``nonbondedslicing_tpu_torch`` is not one."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def card_problem(torch, chips):
    """Why the run cannot measure on ``chips`` cards, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device is available"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} CUDA devices, "
                f"{torch.cuda.device_count()} are visible")
    return None


def power_limit():
    """The card's power limit as nvidia-smi reports it, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.strip())
    except ValueError:
        return None
