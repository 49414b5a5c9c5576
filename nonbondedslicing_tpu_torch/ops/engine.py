"""Parameter tensors and the lambda contraction of slice energies.

Slice energies are *unscaled* by lambda: the total energy is
``sum(lam * slice_energies)`` and, because E is lambda-linear, the exact
dE/dlambda derivatives are sums of slice energies
(ReferenceNonbondedSlicingKernels.cpp:252-265).  ``data`` carries every
mutable parameter array, so parameter updates never rebuild an engine.
"""

import numpy as np
import torch

from .plan import Plan

DATA_KEYS = ("base_params", "charge_offsets", "sigma_offsets",
             "epsilon_offsets", "subsets", "exclusion_pairs",
             "exclusion_list", "nb14_atoms", "nb14_base", "nb14_slice",
             "nb14_charge_offsets", "nb14_sigma_offsets",
             "nb14_epsilon_offsets", "dispersion_coefficients")


def data_from_numpy(data_np, *, device, dtype):
    """A dict of numpy parameter arrays (the keys of :data:`DATA_KEYS`,
    e.g. the JAX package's ``plan_data(plan)`` converted with
    ``np.asarray``) -> tensors on ``device``: floating arrays in ``dtype``,
    integer arrays as int64."""
    out = {}
    for key in DATA_KEYS:
        arr = np.asarray(data_np[key])
        if arr.dtype.kind == "f":
            out[key] = torch.tensor(arr, device=device).to(dtype)
        else:
            out[key] = torch.tensor(arr.astype(np.int64), device=device)
    return out


def plan_data(plan: Plan, *, device="cuda", dtype=torch.float64):
    """The mutable-parameter tensors of a plan, on the card unless the
    caller names another device (the MD step runs where ``data`` lies)."""
    return data_from_numpy({k: getattr(plan, k) for k in DATA_KEYS},
                           device=device, dtype=dtype)


def contract_energy(slice_energies, lam):
    """E = sum(lam * slice_energies) (ReferenceNonbondedSlicingKernels.cpp:252-257)."""
    return torch.sum(lam.to(slice_energies.dtype) * slice_energies)


def parameter_derivatives(slice_energies, deriv_mask):
    """dE/dlambda_p = sum of unscaled slice energies assigned to p
    (ReferenceNonbondedSlicingKernels.cpp:259-265)."""
    mask = torch.as_tensor(np.asarray(deriv_mask), dtype=slice_energies.dtype,
                           device=slice_energies.device)
    return torch.einsum("dst,st->d", mask, slice_energies)
