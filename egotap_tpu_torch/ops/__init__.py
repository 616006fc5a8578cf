"""Kernel wrappers, each beside its plain PyTorch version.

Each kernel module holds ``TOL``: per dtype, the limits ``(max, rms)``
within which its kernel must agree with its plain version on the card,
as `kernel_errors` reads them. The max error catches a fault confined
to a few elements; the rms error catches a small fault spread over all
of them (a skipped bf16 operand rounding), which one-ulp flips of the
final bf16 rounding would hide from the max.

Gradients: on the card the wrappers of kernels A, B and C are the
forward of a `torch.autograd.Function` whose backward is autograd over
the plain version, recomputed from the saved inputs (`plain_vjp`).
Kernel D (int8 inference) has no backward: its wrapper refuses inputs
that need a gradient (`refuse_grad`) instead of returning an output cut
off from autograd. On the CPU the plain versions differentiate.
"""

from __future__ import annotations

import torch

from egotap_tpu_torch.utils import profiling


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
    a kernel whose plain version is ``plain``. The work runs in a span
    named ``label`` (`utils.profiling.span`; in a profiler's trace, a
    range of exactly that name)."""
    need = list(need[:len(saved)])
    if not any(need):
        return (None,) * len(saved)
    with profiling.span(label, prefix=""), torch.enable_grad():
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


def launch_counts(reset: bool = False) -> dict:
    """Each kernel wrapper's count of its launches, by kernel (zeroed
    first with ``reset``)."""
    from egotap_tpu_torch.ops import (attention, fused_layer1, pu_kernel,
                                      upsample)
    wrappers = {"upsample": upsample.upsample2x_align_corners,
                "attention": attention.multihead_attention_packed,
                "pu_chain": pu_kernel.pu_chain_fused,
                "attention_unpacked": attention.multihead_attention,
                "fused_layer1": fused_layer1.fused_layer1_int8}
    if reset:
        for w in wrappers.values():
            w.launches = 0
        attention.multihead_attention_packed.launches_by_heads.clear()
    return {n: w.launches for n, w in wrappers.items()}


def attention_launches_by_heads() -> dict:
    """Kernel B's launches through the packed wrapper, by head count
    (zeroed with ``launch_counts(reset=True)``)."""
    from egotap_tpu_torch.ops import attention
    return dict(attention.multihead_attention_packed.launches_by_heads)
