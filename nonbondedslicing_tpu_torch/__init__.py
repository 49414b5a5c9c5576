"""nonbondedslicing_tpu_torch — the sliced nonbonded engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``nonbondedslicing_tpu`` (JAX/Pallas, kept beside it as the
reference).  Particles sit in n subsets; the energy splits into n(n+1)/2
slices, each scaled by its own lambda_Coulomb and lambda_vdW, with exact
dE/dlambda from the unscaled slice energies.

The ported path is the fused PME MD step: the force/System API
(``models``), ``ops.plan.build_plan``, ``ops.engine.plan_data`` and
``runtime.fastpath.make_md_step`` over ``ops.fused.make_fused_engine``.  Its
three kernels (direct-space pairs, PME spread, PME interpolation) live in
``csrc/`` and are built with nvcc at first use
(``runtime/kernels.py``); CPU tensors take their plain PyTorch twins.
"""

import torch

# reference-grade float32: matmuls and convolutions never drop to TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .models.force import (HarmonicBondForce, NonbondedForce,  # noqa: E402
                           OpenMMException, SlicedNonbondedForce)
from .models.system import System  # noqa: E402
from .utils.indexing import slice_index as sliceIndex  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "SlicedNonbondedForce",
    "NonbondedForce",
    "HarmonicBondForce",
    "OpenMMException",
    "System",
    "sliceIndex",
]
