"""The least device time of the port's kernels, from the shapes of a call.

A kernel's bound is the larger of its bytes (each input byte read once,
each output byte written once) at the card's memory bandwidth and its
operations at the peak of the units it runs on. The shapes of each call
follow from the configuration (`forward_calls`); the program is not asked.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark import reference as R

# the name each kernel's device function carries in a profiler trace
KERNELS = {"upsample": "upsample2x_kernel", "attention": "attention_",
           "pu_chain": "pu_chain_kernel"}


def upsample_bound(shape, itemsize: int, peaks: Dict) -> float:
    """Kernel A, 2x bilinear upsampling of (n, h, w, c): the input read
    once and four times its size written; three lerps (2 operations each)
    an output element, on the CUDA cores in f32."""
    n, h, w, c = shape
    elems = n * h * w * c
    return max(5 * elems * itemsize / peaks["hbm_bytes_per_s"],
               24 * elems / peaks["f32_flops_per_s"])


def attention_bound(b: int, s: int, d: int, itemsize: int,
                    peaks: Dict) -> float:
    """Kernel B, softmax attention on packed (b, s, d) q, k, v: q, k, v
    read and the output written once; QK^T and PV, 2 * b * s^2 * d
    operations each, at the bf16 tensor-core peak."""
    return max(4 * b * s * d * itemsize / peaks["hbm_bytes_per_s"],
               4 * b * s * s * d / peaks["bf16_flops_per_s"])


def pu_chain_bound(b: int, joints: int, hidden: int, itemsize: int,
                   peaks: Dict) -> float:
    """Kernel C, the 2-layer PU chain over ``joints`` at width ``hidden``:
    13 hidden^2 products a joint and row (layer 0's h2h, layer 1's x2f,
    x2h, h2h); its 13 hidden^2 weights in the compute dtype, the f32
    forget gates, gate preactivations, output and biases."""
    h = hidden
    flops = 2 * b * h * 13 * h * joints
    nbytes = (13 * h * h * itemsize
              + 4 * (b * joints * h + b * joints * 4 * h + b * joints * h
                     + 9 * h))
    return max(nbytes / peaks["hbm_bytes_per_s"],
               flops / peaks["bf16_flops_per_s"])


def forward_calls(cfg: Dict, batch: int) -> Dict[str, List[Tuple]]:
    """The kernels' calls of one serving forward at ``batch``: kernel A
    three times in each heatmap net's decoder, B once in each ViT layer,
    C once."""
    exp = 4 if R.RESNETS[cfg["model_name"]][0] == "bottleneck" else 1
    fs = exp * cfg["views"]
    s = cfg["image_size"] // 32
    a = [(batch, s, s, 512 * fs), (batch, 2 * s, 2 * s, 512 * fs),
         (batch, 4 * s, 4 * s, 256 * fs)]
    w = cfg["widths"]
    return {"upsample": a * 2,
            "attention": [(batch, w["vit_tokens"], w["vit_hidden"])]
            * w["vit_layers"],
            "pu_chain": [(batch, cfg["num_heatmap"], w["pu_hidden"])]}


def forward_bounds(cfg: Dict, batch: int, itemsize: int,
                   peaks: Dict) -> Dict[str, float]:
    """Seconds: each kernel's summed bound over one forward's calls."""
    calls = forward_calls(cfg, batch)
    return {
        "upsample": sum(upsample_bound(c, itemsize, peaks)
                        for c in calls["upsample"]),
        "attention": sum(attention_bound(*c, itemsize, peaks)
                         for c in calls["attention"]),
        "pu_chain": sum(pu_chain_bound(*c, itemsize, peaks)
                        for c in calls["pu_chain"]),
    }
