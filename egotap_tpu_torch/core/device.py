"""Device resolution for the port's entry points (no JAX counterpart).

Entry points run on the card unless the caller asks for the CPU: with
no GPU and no explicit ``device="cpu"`` they raise instead of silently
running somewhere else.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "egotap_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_f32_numerics() -> None:
    """Full-f32 matmuls and convolutions on the card.

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits), which would break the f32 parity path; matmuls are set too so
    that the setting is stated, not assumed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
