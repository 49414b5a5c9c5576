"""The arithmetic the reference runs in.

``"f64"`` is the reference.  ``"tf32"`` is the control: float32 storage
with the result of every step of the force and energy arithmetic rounded
to TF32's 10-bit mantissa, the precision one step below the float32 that
the configurations state (float32 with TF32 off)."""

import torch

MODES = ("f64", "tf32")


def dtype_of(mode):
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r} (one of {MODES})")
    return torch.float64 if mode == "f64" else torch.float32


def tf32_round(x):
    """``x`` (float32) rounded to the nearest value with a 10-bit
    mantissa, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(bits, 13), 1)
    bits = torch.bitwise_and(bits + 0xFFF + lsb, ~0x1FFF)
    return bits.view(torch.float32)


def rounder(mode):
    """The rounding applied after each step of the arithmetic."""
    dtype_of(mode)
    return tf32_round if mode == "tf32" else (lambda x: x)
