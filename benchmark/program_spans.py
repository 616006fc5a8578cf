"""The program's own spans (`egotap_tpu_torch.utils.profiling`), as the
per-layer readers with source ``program_span`` read them.

The program records its spans while a profiler runs, so in a run these
are the traced window's, plus its set-up spans, which record always. A
reading is None when there is nothing to read: a program without the
spans (the module has no `summary`), a root count other than the traced
window's units, or a record dropped from the program's bounded buffer.
"""

from __future__ import annotations

from typing import Dict, Optional


def _summary() -> Optional[Dict[str, Dict[str, float]]]:
    from egotap_tpu_torch.utils import profiling
    summary = getattr(profiling, "summary", None)
    if summary is None or profiling.dropped():
        return None
    return summary()


def per_root_ms(run, root: str, *names: str) -> Optional[float]:
    """Host ms a root span (a request, a step) of the spans ``names``,
    summed, over the traced window's ``root`` spans."""
    s = _summary()
    if s is None or s.get(root, {}).get("count") != run.traced_units \
            or any(n not in s for n in names):
        return None
    return sum(s[n]["total_ms"] for n in names) / run.traced_units


def total_s(name: str) -> Optional[float]:
    """Seconds inside the spans ``name`` (one nested in its own name
    counted once)."""
    s = _summary()
    if s is None or name not in s:
        return None
    return s[name]["total_ms"] / 1e3
