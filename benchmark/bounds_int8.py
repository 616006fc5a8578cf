"""The least device time of the int8 products of a serving forward.

A product of (M, K) int8 codes by (N, K) int8 codes into (M, N) int32 is
bound by the larger of its 2·M·N·K operations at the card's dense int8
tensor-core peak and its bytes (M·K + N·K in, 4·M·N out, each once) at
the card's memory bandwidth. The shapes come from the plain int8
reference (`reference_int8.int8_products`); the program is not asked.
`peaks.json` has no int8 peak, so it is kept here, by the same card key.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# dense int8 tensor-core operations a second, no sparsity (NVIDIA H100
# SXM data sheet), for the card whose `peaks.json` entry is matched
INT8_OPS_PER_S = 1.979e15


def product_bound(m: int, n: int, k: int, peaks: Dict) -> float:
    """Seconds: one (M, K) x (N, K)^T int8 product's bound."""
    return max(2 * m * n * k / INT8_OPS_PER_S,
               (m * k + n * k + 4 * m * n) / peaks["hbm_bytes_per_s"])


def products_bound(products: Iterable[Tuple[int, int, int]],
                   peaks: Dict) -> float:
    """Seconds: the summed bound of ``products`` ((M, N, K) each)."""
    return sum(product_bound(m, n, k, peaks) for m, n, k in products)
