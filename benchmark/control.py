"""Readings of the check: sound runs of the program, the lower-precision
controls and planted faults, for setting each limit (on the card).

    python3 benchmark/control.py --workload r18.serve-b32 \
        --seeds 101,102,103 --control-seeds 201,202,203 --seconds 2

Prints one JSON line per run: the seed, the mode and every number the
check computes. Modes:

  * ``sound``: the system under test as the cell runs it (a serving cell
    with a short window at the cell's own load; a training cell with its
    set-up steps, which are the steps the check compares);
  * ``control``: serving: the program's own int8 path in its place
    (`Predictor(int8=True)`, static scales calibrated on 2 batches of
    frames + 0.1 noise, as the int8 deployment does); training: the
    reference computed with float8 operands in the program's place;
  * ``int8_lifter`` and ``fp8_lifter`` (serving, ``--stage2-seeds``):
    stage 2 alone below bfloat16, the heatmap nets as the cell runs them:
    the program's int8 lifter (``int8_lifter_inference``, calibrated as
    above), and the reference lifter with float8 operands put in the
    program's lifter's place;
  * ``fault``: training: the reference with the loss over half of each
    batch in the program's place; serving: the program with one joint of
    the first pose of each answer negated where the pose is produced.

The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import harness  # noqa: E402


def int8_program(cfg, states, device, seed, batch):
    """The `Predictor` on its int8 path."""
    from benchmark.drivers import serve
    return serve.predictor(cfg, states, device, seed, batch, int8=True)


def int8_lifter_program(cfg, states, device, seed, batch):
    """The `Predictor` with its int8 lifter alone."""
    from benchmark.drivers import serve
    cfg = dict(cfg, int8_lifter_inference=True,
               program=cfg["program"] + ["int8_lifter_inference"])
    return serve.predictor(cfg, states, device, seed, batch)


def fp8_lifter_program(cfg, states, device, seed, batch):
    """The `Predictor` with the reference lifter, its products on float8
    operands, in place of its own lifter."""
    import torch
    from torch import nn
    from benchmark import reference as R
    from benchmark.drivers import serve

    class ReferenceLifter(nn.Module):
        def __init__(self, lifter):
            super().__init__()
            self.ref, self.ar = lifter, R.Arith(fp8=True)
            # where the check's hook reads the per-joint features
            self.skel_sequential_layer = nn.ModuleDict({"tap": nn.Identity()})

        def forward(self, hm):
            taps = {}
            pose = self.ref(hm.float(), self.ar, taps=taps)
            self.skel_sequential_layer["tap"](taps["skel"])
            return pose

    pred = serve.predictor(cfg, states, device, seed, batch)
    with torch.device("meta"):
        lifter = R.EgoTAP(cfg).lifter
    lifter = lifter.to_empty(device=device)
    lifter.load_state_dict(states["lifter"], strict=True)
    pred.lifter = ReferenceLifter(lifter.eval())
    pred.nets = (pred.pos_net, pred.rot_net, pred.lifter)
    return pred


def altered_answers():
    """Plant the fault: the serving forward negates joint 3 of the first
    pose of every answer it produces."""
    import egotap_tpu_torch.serving as serving
    sound = serving.pose_forward

    def altered(nets, rgb, dtype):
        out = sound(nets, rgb, dtype)
        out[0, 3] = -out[0, 3]
        return out
    serving.pose_forward = altered
    return lambda: setattr(serving, "pose_forward", sound)


def serve_readings(cell, seed, seconds, device, program=None):
    t = time.perf_counter()
    res = harness.run_cell(cell, seed, seconds, False, device, t, {},
                           program=program, log=lambda m: None)
    return res["readings"]


def train_readings(cell, seed, device, mode):
    from benchmark.drivers import train_lifter as train
    if mode == "sound":
        drv = train.Driver(cell, seed, device)
        drv.setup({})
        return drv.check()
    import torch
    from benchmark import reference as R
    cfg, tr = cell.config, cell.traffic
    batches = train.draw_pool(cfg, tr, seed, device)[:tr["check_steps"]]
    R.f32_numerics()
    ref = train.reference_readings(cfg, seed, batches, device)
    torch.cuda.empty_cache()
    if mode == "control":
        prog = train.reference_readings(cfg, seed, batches, device,
                                        ar=R.Arith(fp8=True))
    else:
        prog = train.reference_readings(cfg, seed, batches, device,
                                        batch_fault="half")
    return train.compare(prog, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--stage2-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    is_serve = cell.traffic["kind"] == "serve"

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    runs = [(s, "sound") for s in seeds(args.seeds)]
    runs += [(s, "control") for s in seeds(args.control_seeds)]
    runs += [(s, "fault") for s in seeds(args.fault_seeds)]
    runs += [(s, m) for s in seeds(args.stage2_seeds)
             for m in ("int8_lifter", "fp8_lifter")]
    for seed, mode in runs:
        t = time.perf_counter()
        if is_serve:
            undo = None
            program = {"control": int8_program,
                       "int8_lifter": int8_lifter_program,
                       "fp8_lifter": fp8_lifter_program}.get(mode)
            if mode == "fault":
                undo = altered_answers()
            try:
                out = serve_readings(cell, seed, args.seconds, "cuda",
                                     program)
            finally:
                if undo is not None:
                    undo()
        else:
            out = train_readings(cell, seed, "cuda", mode)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": mode, "readings": out,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
