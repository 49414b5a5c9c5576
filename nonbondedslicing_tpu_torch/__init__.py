"""nonbondedslicing_tpu_torch — the sliced nonbonded engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``nonbondedslicing_tpu`` (JAX/Pallas, kept beside it as the
reference).  Particles sit in n subsets; the energy splits into n(n+1)/2
slices, each scaled by its own lambda_Coulomb and lambda_vdW, with exact
dE/dlambda from the unscaled slice energies.

Users drive it as the JAX package: a ``System`` with its forces, a
``Context(system, VerletIntegrator(dt), Platform.getPlatformByName("CUDA"))``,
``integrator.step(n)`` and ``context.getState(...)`` (``models/context.py``).
Under it: ``ops.plan.build_plan``, ``ops.engine.plan_data`` and
``make_compute`` (every evaluation), and ``runtime.fastpath.make_md_step``
over ``ops.fused.make_fused_engine`` (the MD step).  The kernels
(direct-space pairs, PME spread, fold, extract and interpolation) live in
``csrc/`` and are built with nvcc at first use (``runtime/kernels.py``);
CPU tensors take their plain PyTorch twins.
"""

import torch

# reference-grade float32: matmuls and convolutions never drop to TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .models.force import (HarmonicBondForce, NonbondedForce,  # noqa: E402
                           OpenMMException, SlicedNonbondedForce)
from .models.system import System  # noqa: E402
from .models.context import (Context, Platform, State,  # noqa: E402
                             VerletIntegrator)
from .serialization.xml_proxy import XmlSerializer  # noqa: E402
from .utils.indexing import slice_index as sliceIndex  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "SlicedNonbondedForce",
    "NonbondedForce",
    "HarmonicBondForce",
    "OpenMMException",
    "System",
    "Context",
    "Platform",
    "State",
    "VerletIntegrator",
    "XmlSerializer",
    "sliceIndex",
]
