"""Readings of the int8 serving cell's check: sound runs of the program,
the controls and the planted fault, for setting each limit (on the card).

    python3 benchmark/control_int8.py --workload r18-int8.serve-b32 \
        --modes sound,int4,bf16,fault --seeds 101,102,103 --seconds 2

Prints one JSON line per run: the seed, the mode and every number the
check computes (the float32 readings and the int8-reference ones).
Modes:

  * ``sound``: the program as the cell runs it (a short window at the
    cell's own load);
  * ``int4``: the plain int8 reference at ``bits=4`` (codes within +-7,
    its own static scales calibrated on the cell's frames) in the place of
    the program's three nets: the control below the configuration's
    precision, for the float32 readings;
  * ``bf16``: the program's bfloat16 `Predictor` with int8 off in the
    int8 configuration's place: a change that quietly stops running int8,
    for the int8-reference readings;
  * ``float_products``: the program calibrated as the cell calibrates it,
    then every int8 module's product computed as a float one in the
    compute dtype (trunk, decoder and lifter): int8 quietly dropped with
    the static scales in place, for ``int8_product_rms``;
  * ``lifter_float``: the same in the lifter's projections alone (its
    `QDense` products run as bfloat16 library products);
  * ``miscal``: the program with every static scale it calibrated
    multiplied by 1.5 (a calibration fault: codes a third coarser), for
    ``int8_scale_gap``;
  * ``onebatch``: the program calibrated on one batch of frames without
    the noise (another protocol), for ``int8_scale_gap``;
  * ``fused``: the program with its dequantise computed in float64 and
    rounded once to the stored dtype, as a fused epilogue may round it: a
    sound variant, which every limit has to pass;
  * ``fault``: the program with one joint of the first pose of each answer
    negated where the pose is produced (`control.altered_answers`).

The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import control, harness  # noqa: E402

MODES = ("sound", "int4", "bf16", "float_products", "lifter_float",
         "miscal", "onebatch", "fused", "fault")


def bf16_program(cfg, states, device, seed, batch):
    """The `Predictor` with int8 off."""
    from benchmark.drivers import serve
    return serve.predictor(cfg, states, device, seed, batch, int8=False)


def float_products(stage1: bool = True):
    """Run the int8 modules' products as float products in the compute
    dtype: the lifter's `QDense`, and with ``stage1`` the decoder's
    `QConv` and the trunk's BN-folded convolutions; returns the undo."""
    import torch.nn.functional as F
    from egotap_tpu_torch.models import resnet
    from egotap_tpu_torch.ops import quant
    saved = []

    def patch(cls, name, fn):
        saved.append((cls, name, cls.__dict__[name]))
        setattr(cls, name, fn)

    def cast(t, like):
        return None if t is None else t.to(like.dtype)

    def dense(self, x, pre_q=None):
        return F.linear(x, cast(self.weight, x), cast(self.bias, x))

    def conv(self, x):
        out = quant.conv_nhwc_float(x, cast(self.weight, x), self.stride[0],
                                    self.padding[0])
        return out if self.bias is None else out + cast(self.bias, out)

    def folded(self, inp, conv, bn):
        w, c = resnet._fold(conv, bn)
        out = quant.conv_nhwc_float(inp, cast(w, inp), conv.stride[0],
                                    conv.padding[0])
        return out + cast(c, out)
    patch(quant.QDense, "forward", dense)
    if stage1:
        patch(quant.QConv, "forward", conv)
        patch(resnet.BasicBlock, "_folded_conv", folded)
    return lambda: [setattr(*s) for s in saved]


def miscal_program(cfg, states, device, seed, batch):
    """The `Predictor` with its static scales 1.5 times too large."""
    from benchmark.drivers import serve
    from egotap_tpu_torch.ops.quant import Calibrated
    pred = serve.predictor(cfg, states, device, seed, batch)
    for net in pred.nets:
        for m in net.modules():
            if isinstance(m, Calibrated) and m.a_scale is not None:
                m.a_scale.mul_(1.5)
    return pred


def onebatch_program(cfg, states, device, seed, batch):
    """The `Predictor` calibrated on one batch of frames, no noise."""
    import torch
    from benchmark import weights as W
    from benchmark.common import KEYS, port_config
    from egotap_tpu_torch.serving import Predictor
    with torch.device(device):
        pred = Predictor(port_config(cfg), states["pos_net"],
                         states["rot_net"], states["lifter"],
                         bf16=cfg["precision"] == "bfloat16", device=device)
    return pred.calibrate(W.frames(batch, cfg["image_size"], 1, seed,
                                   KEYS["calibration"], device))


def calibrated_then(patch, undos):
    """A program: the `Predictor` as the cell builds and calibrates it,
    then ``patch()``, whose undo goes to ``undos``."""
    def program(cfg, states, device, seed, batch):
        from benchmark.drivers import serve
        pred = serve.predictor(cfg, states, device, seed, batch)
        undos.append(patch())
        return pred
    return program


def fused_dequantize():
    """Compute the program's dequantise in float64, rounded once to the
    stored dtype; returns the undo."""
    from egotap_tpu_torch.ops import quant
    sound = quant.dequantize

    def once(acc, a_scale, w_scale, bias, dtype):
        out = acc.double() * (a_scale.double() * w_scale.double())
        if bias is not None:
            out = out + bias.double()
        return out.to(dtype)
    quant.dequantize = once
    return lambda: setattr(quant, "dequantize", sound)


def int4_program(cfg, states, device, seed, batch):
    """The `Predictor`'s request path with the plain reference at 4 bits in
    place of its nets."""
    import torch
    from torch import nn
    from benchmark import reference as R
    from benchmark import reference_int8 as Q
    from benchmark.drivers import serve

    with torch.device("meta"):
        model = R.EgoTAP(cfg)
    model = model.to_empty(device=device)
    for name in ("pos_net", "rot_net", "lifter"):
        getattr(model, name).load_state_dict(states[name], strict=True)
    ref = Q.Int8EgoTAP(model, cfg, bits=4,
                       bf16=cfg["precision"] == "bfloat16")
    ref.calibrate(serve.calibration_frames(cfg, seed, batch, device))

    class Net(nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, rgb):
            return ref.heatmap_net(self.net, rgb.float()).to(rgb.dtype)

    class Lifter(nn.Module):
        def __init__(self):
            super().__init__()
            # where the check's hook reads the per-joint features
            self.skel_sequential_layer = nn.ModuleDict({"tap": nn.Identity()})

        def forward(self, hm):
            taps = {}
            pose = ref.lifter(hm, taps=taps)
            self.skel_sequential_layer["tap"](taps["skel"])
            return pose

    pred = serve.predictor(cfg, states, device, seed, batch, int8=False)
    pred.pos_net, pred.rot_net = Net(model.pos_net), Net(model.rot_net)
    pred.lifter = Lifter()
    pred.nets = (pred.pos_net, pred.rot_net, pred.lifter)
    return pred


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="r18-int8.serve-b32")
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control_int8: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    modes = [m for m in args.modes.split(",") if m]
    unknown = set(modes) - set(MODES)
    if unknown:
        raise SystemExit(f"control_int8: unknown modes {sorted(unknown)}")
    for mode in modes:
        for seed in (int(s) for s in args.seeds.split(",") if s):
            t = time.perf_counter()
            undos = []
            if mode in ("fault", "fused"):
                undos.append({"fault": control.altered_answers,
                              "fused": fused_dequantize}[mode]())
            program = {
                "int4": int4_program, "bf16": bf16_program,
                "miscal": miscal_program, "onebatch": onebatch_program,
                "float_products": calibrated_then(float_products, undos),
                "lifter_float": calibrated_then(
                    lambda: float_products(False), undos)}.get(mode)
            try:
                out = control.serve_readings(cell, seed, args.seconds,
                                             "cuda", program)
            finally:
                for undo in undos:
                    undo()
            torch.cuda.empty_cache()
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "readings": out,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
