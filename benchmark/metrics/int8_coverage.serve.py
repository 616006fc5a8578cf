"""int8_coverage.serve: the program's ``int8.macs`` counter a request (the
M·N·K of every integer product it ran, counted under its ``serve.request``
root spans in the traced window) over the int8 MACs a forward of the
configuration asks for (`reference_int8.int8_products`), in %: 100 when
every product that the configuration states is int8 ran in int8."""


def read(run):
    from egotap_tpu_torch.utils import profiling
    want = getattr(run, "int8_macs_per_unit", None)
    counters = getattr(profiling, "counters", None)
    if not want or counters is None or profiling.dropped():
        return None
    if profiling.summary().get("serve.request", {}).get("count") \
            != run.traced_units:
        return None
    macs = counters().get("serve.request", {}).get("int8.macs", 0)
    return 100.0 * macs / run.traced_units / want
