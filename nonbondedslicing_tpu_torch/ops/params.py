"""Runtime parameter resolution.

Analog of the reference's ``computeParameters``
(ReferenceNonbondedSlicingKernels.cpp:339-392): apply global-parameter offsets
to base charges/sigmas/epsilons and pack particle parameters as
(sigma/2, 2*sqrt(epsilon), charge) and 1-4 parameters as
(sigma, 4*epsilon, chargeProd).  The global parameters are tensor inputs, so
lambda/offset changes never rebuild anything.
"""

import torch


def particle_params(data, gvals):
    """Return (charge, sig_half, eps_sqrt2) tensors of shape (N,)."""
    base = data["base_params"]
    charge = base[:, 0] + gvals @ data["charge_offsets"]
    sigma = base[:, 1] + gvals @ data["sigma_offsets"]
    epsilon = base[:, 2] + gvals @ data["epsilon_offsets"]
    return charge, 0.5 * sigma, 2.0 * torch.sqrt(epsilon)


def nb14_params(data, gvals):
    """Return (sigma, 4*epsilon, chargeProd) tensors of shape (M,)."""
    base = data["nb14_base"]
    charge = base[:, 0] + gvals @ data["nb14_charge_offsets"]
    sigma = base[:, 1] + gvals @ data["nb14_sigma_offsets"]
    epsilon = base[:, 2] + gvals @ data["nb14_epsilon_offsets"]
    return sigma, 4.0 * epsilon, charge


def slice_lambdas(lam_source, gvals):
    """(S, 2) lambda table; entries default to 1 when no scaling parameter is
    bound (ReferenceNonbondedSlicingKernels.cpp:343-347).  ``lam_source`` is
    the plan's (S, 2) table of global-parameter indices (-1: none), as
    numpy or as an int64 tensor on the device of ``gvals``."""
    src = torch.as_tensor(lam_source, dtype=torch.int64, device=gvals.device)
    if gvals.shape[0] == 0:
        return torch.ones(src.shape, dtype=gvals.dtype, device=gvals.device)
    vals = gvals[src.clamp(min=0)]
    return torch.where(src >= 0, vals, torch.ones_like(vals))
