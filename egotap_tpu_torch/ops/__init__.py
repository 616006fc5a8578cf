"""Kernel wrappers, each beside its plain PyTorch version.

Each kernel module holds ``TOL``: per dtype, the limits ``(max, rms)``
within which its kernel must agree with its plain version on the card,
as `kernel_errors` reads them. The max error catches a fault confined
to a few elements; the rms error catches a small fault spread over all
of them (a skipped bf16 operand rounding), which one-ulp flips of the
final bf16 rounding would hide from the max.

Gradients: on the card the wrappers of kernels B and C are the forward
of a `torch.autograd.Function` whose backward is autograd over the
plain version, recomputed from the saved inputs (`plain_vjp`). Kernels A
and D have no backward yet: their wrappers refuse inputs that need a
gradient (`refuse_grad`) instead of returning an output cut off from
autograd. On the CPU the plain versions differentiate.
"""

from __future__ import annotations

import torch


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad:
    a kernel's output would carry no ``grad_fn`` (run it under
    ``torch.no_grad()``, as the serving forward does)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} kernel has no backward: call it under torch.no_grad() "
            "or with inputs that do not require grad")


def plain_vjp(plain, saved, need, grad, label):
    """The vector-Jacobian product of ``plain`` at the tensors ``saved``
    with the output gradient ``grad``: ``plain`` is recomputed under
    autograd from detached copies. One gradient per saved tensor, None
    where ``need`` (``ctx.needs_input_grad``) is false: the backward of
    a kernel whose plain version is ``plain``. The work runs in a
    profiler range named ``label``."""
    need = list(need[:len(saved)])
    if not any(need):
        return (None,) * len(saved)
    with torch.profiler.record_function(label), torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        out = plain(*leaves)
        grads = torch.autograd.grad(
            out, [x for x, n in zip(leaves, need) if n], grad)
    it = iter(grads)
    return tuple(next(it) if n else None for n in need)


def kernel_errors(got: torch.Tensor, ref: torch.Tensor):
    """(max |got-ref|, max |got-ref| / max |ref|, rms(got-ref) / rms(ref))."""
    got, ref = got.double(), ref.double()
    diff = got - ref
    max_abs = diff.abs().max().item()
    max_rel = max_abs / max(ref.abs().max().item(), 1e-30)
    rms_rel = (diff.square().mean().sqrt()
               / ref.square().mean().sqrt().clamp_min(1e-30)).item()
    return max_abs, max_rel, rms_rel
