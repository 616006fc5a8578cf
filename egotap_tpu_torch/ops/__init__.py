"""Kernel wrappers, each beside its plain PyTorch version.

Each kernel module holds ``TOL``: per dtype, the limits ``(max, rms)``
within which its kernel must agree with its plain version on the card,
as `kernel_errors` reads them. The max error catches a fault confined
to a few elements; the rms error catches a small fault spread over all
of them (a skipped bf16 operand rounding), which one-ulp flips of the
final bf16 rounding would hide from the max.
"""

from __future__ import annotations

import torch


def kernel_errors(got: torch.Tensor, ref: torch.Tensor):
    """(max |got-ref|, max |got-ref| / max |ref|, rms(got-ref) / rms(ref))."""
    got, ref = got.double(), ref.double()
    diff = got - ref
    max_abs = diff.abs().max().item()
    max_rel = max_abs / max(ref.abs().max().item(), 1e-30)
    rms_rel = (diff.square().mean().sqrt()
               / ref.square().mean().sqrt().clamp_min(1e-30)).item()
    return max_abs, max_rel, rms_rel
