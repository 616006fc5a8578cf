"""Multi-process dry runs of the data-parallel paths.

The torch twin of `__graft_entry__.py:dryrun_multichip`: it spawns
``--nproc`` ranks of itself, joined through a `torch.distributed.FileStore`
in ``--out`` (no ports), waits for each (``--timeout`` seconds) and fails
when one fails. Ranks given one indexed card (``--device cuda:0``) share
it; they need ``--backend gloo``, as NCCL refuses two ranks on one device.

    python -m egotap_tpu_torch.parallel.dryrun --nproc 2 --device cpu \\
        --out /tmp/dry                       # the multi-chip dry run

Modes (``--mode``, one or more, run in order by the same ranks):
  * ``dryrun``: the stage-2 training step of the flagship configuration
    at a tiny size on a synthetic dataset, each rank on its shard, then
    an eval step, then on rank 0 the tensor-parallel `Predictor` (two
    model shards a data shard) over ``[device] * nproc``.
  * ``step``: one `train_step` from the checkpoint ``--init`` (a
    ``ckpt_*`` directory) of the ``--config`` JSON's configuration, on
    rank r's rows ``[r * b, (r + 1) * b)`` of the preprocessed batch
    ``--batch`` (an ``.npz``); each of the three flags may be repeated,
    one step a job. Each rank saves its losses, net, frozen nets,
    gradients, kernel launches (and kernel B's by head count) and the
    step's wall time as
    ``{out}/rank{r}_{job}.pt``; with
    ``--control``, then the faulty control from the same state
    (BatchNorm statistics per rank) as ``{out}/control{r}_{job}.pt``.
  * ``probe``: which collectives the backend takes on tensors of
    ``--device``; rank 0 prints each one's outcome.
  * ``cli``: `cli.train.main` then `cli.test.main` on the argv after
    ``--``; each rank saves its test metrics, pairs/s and kernel
    launches as ``{out}/rank{r}.pt``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def _args(argv):
    p = argparse.ArgumentParser(prog="python -m egotap_tpu_torch.parallel."
                                "dryrun")
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None,
                   help="default: NCCL for CUDA ranks, gloo on the CPU "
                   "(ranks sharing one card need gloo)")
    p.add_argument("--mode", nargs="+", default=["dryrun"],
                   choices=("dryrun", "step", "cli", "probe"),
                   help="one or more, run in order in the same ranks")
    p.add_argument("--out", required=True)
    p.add_argument("--config", action="append", default=[])
    p.add_argument("--init", action="append", default=[])
    p.add_argument("--batch", action="append", default=[])
    p.add_argument("--control", action="store_true")
    p.add_argument("--timeout", type=float, default=600)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("rest", nargs="*")
    return p.parse_args(argv)


def launch(argv) -> int:
    """Spawn the ranks and wait for them; returns 0 when every rank
    returned 0."""
    args = _args(argv)
    os.makedirs(args.out, exist_ok=True)
    store = os.path.join(args.out, "store")
    if os.path.exists(store):
        os.remove(store)
    base = [sys.executable, "-m", "egotap_tpu_torch.parallel.dryrun"]
    procs = [subprocess.Popen(base + ["--rank", str(r)] + list(argv))
             for r in range(args.nproc)]
    deadline = time.monotonic() + args.timeout
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        rcs.append(124)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [rc for rc in rcs if rc]
    print(f"dryrun: {args.nproc} ranks, mode {' '.join(args.mode)}: "
          + ("ok" if not bad else f"failed {rcs}"))
    return 1 if bad else 0


def _rank_main(args) -> None:
    from egotap_tpu_torch.parallel import mesh
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    store = torch.distributed.FileStore(os.path.join(args.out, "store"),
                                        args.nproc)
    dp = mesh.init(args.device, rank=args.rank, world_size=args.nproc,
                   store=store, backend=args.backend)
    try:
        for mode in args.mode:
            {"dryrun": _dryrun, "step": _step, "cli": _cli,
             "probe": _probe}[mode](args, dp)
        dp.barrier()
    finally:
        mesh.shutdown()


def _cfg(config: str, **fields):
    from egotap_tpu_torch.core.config import Config
    fields.update(json.loads(config))
    return Config(**fields).derive()


def _step(args, dp) -> None:
    """Each job's training step from its ``--init`` on this rank's rows
    (and with ``--control`` the faulty control)."""
    from egotap_tpu_torch.ops import attention_launches_by_heads, launch_counts
    from egotap_tpu_torch.train import state as state_lib
    from egotap_tpu_torch.train.tasks import create_task
    for job, (config, init, path) in enumerate(zip(args.config, args.init,
                                                   args.batch)):
        cfg = _cfg(config)
        task = create_task(cfg, dp.device, dp)
        data = np.load(path)
        rows = len(data[data.files[0]]) // dp.world
        mine = slice(dp.rank * rows, (dp.rank + 1) * rows)
        batch = {k: torch.from_numpy(data[k][mine]) for k in data.files}
        state = task.init_state(cfg.seed, 1)
        for name in ("rank", "control")[:1 + args.control]:
            state_lib.load_checkpoint(          # the same start for both
                os.path.dirname(init),
                os.path.basename(init)[len("ckpt_"):], state)
            launch_counts(reset=True)
            _sync(dp)
            t0 = time.perf_counter()
            if name == "rank":          # `train_step`'s own
                losses, grads = task.step_gradients(state, batch)
            else:                       # BatchNorm statistics per rank
                task.dp = None
                losses, grads = task.step_gradients(state, batch)
                task.dp = dp
                grads = dp.average_gradients(grads)
                losses = dp.average(losses)
            state.opt.step(dict(state.net.named_parameters()), grads)
            _sync(dp)
            seconds = time.perf_counter() - t0
            torch.save({"losses": {k: float(v) for k, v in losses.items()},
                        "launches": launch_counts(),
                        "heads": attention_launches_by_heads(),
                        "seconds": seconds,
                        "net": state_lib._cpu_state_dict(state.net),
                        "frozen": {k: state_lib._cpu_state_dict(m)
                                   for k, m in state.frozen.items()},
                        "grads": {k: v.cpu() for k, v in grads.items()
                                  if v is not None}},
                       os.path.join(args.out, f"{name}{dp.rank}_{job}.pt"))
            del grads
        del state


def _probe(args, dp) -> None:
    """Each raw collective on tensors of this rank's device, its result
    checked: "ok", the wrong result, or the error it raised."""
    dist, n, dev = torch.distributed, dp.world, dp.device

    def ones(k=1):
        return torch.ones(4 * k, device=dev)

    def all_reduce():
        t = ones()
        dist.all_reduce(t)
        return t / n

    def broadcast():
        t = ones() * (dp.rank + 1)
        dist.broadcast(t, 0)
        return t

    def all_gather():
        out = [ones() * 0 for _ in range(n)]
        dist.all_gather(out, ones())
        return torch.cat(out)

    def all_gather_into_tensor():
        out = ones(n) * 0
        dist.all_gather_into_tensor(out, ones())
        return out

    def reduce_scatter_tensor():
        out = ones() * 0
        dist.reduce_scatter_tensor(out, ones(n))
        return out / n

    def reduce():
        t = ones()
        dist.reduce(t, 0)
        return t / n if dp.main else t

    report = {}
    for op in (all_reduce, broadcast, all_gather, all_gather_into_tensor,
               reduce_scatter_tensor, reduce):
        try:
            got = op()
            report[op.__name__] = ("ok" if bool((got == 1).all())
                                   else f"wrong {got.tolist()}")
        except RuntimeError as e:
            report[op.__name__] = f"RuntimeError: {str(e)[:120]}"
        dist.barrier()
    if dp.main:
        print(f"probe {dp.backend} on {dev}: " + json.dumps(report),
              flush=True)


def _sync(dp) -> None:
    if dp.device.type == "cuda":
        torch.cuda.synchronize(dp.device)


def _cli(args, dp) -> None:
    from egotap_tpu_torch.cli import test, train
    from egotap_tpu_torch.ops import launch_counts
    launch_counts(reset=True)
    train.main(args.rest, device=dp.device)
    metrics, pps = test.main(args.rest, device=dp.device)
    torch.save({"metrics": metrics, "pairs_per_s": pps,
                "launches": launch_counts()},
               os.path.join(args.out, f"rank{dp.rank}.pt"))


def _dryrun(args, dp) -> None:
    """The multi-chip dry run (see the module docstring)."""
    from egotap_tpu_torch.data.pipeline import (make_device_preprocess,
                                                make_loader)
    from egotap_tpu_torch.data.synthetic import generate_dataset
    from egotap_tpu_torch.eval.evaluate import to_device
    from egotap_tpu_torch.serving import Predictor
    from egotap_tpu_torch.train.tasks import LifterTask
    root = os.path.join(args.out, "data")
    if dp.main and not os.path.exists(os.path.join(root, "train.txt")):
        generate_dataset(root, "UnrealEgo", num_sequences=2,
                         frames_per_seq=max(4, dp.world), image_size=16)
    dp.barrier()
    cfg = _cfg(args.config[0] if args.config else "{}", data_dir=root,
               default_data_path="./SyntheticData",
               model="egotap_autoencoder", num_heatmap=15,
               num_rot_heatmap=15, heatmap_type="sin", skel_layer="PU",
               ae_hidden_size=128, load_size_heatmap=(16, 16),
               batch_size=2 * dp.world, niter=1, niter_decay=15,
               use_amp=True, data_parallel=dp.world)
    task = LifterTask(cfg, dp.device, dp)
    loader = make_loader(cfg, "train", None, dp.rank, dp.world)
    batch = next(iter(loader))
    feed = make_device_preprocess(cfg)(to_device(batch, dp.device))
    state = task.init_state(0, len(loader))
    dp.broadcast_modules([state.net, *state.frozen.values()])
    state, losses = task.train_step(state, feed)
    losses = {k: float(v) for k, v in losses.items()}
    assert all(np.isfinite(v) for v in losses.values()), losses
    mpjpe = task.eval_step(state, feed)["metrics"]["mpjpe"]
    assert bool(torch.isfinite(mpjpe).all()), mpjpe
    note = ""
    if dp.main and dp.world >= 2:
        pred = Predictor(cfg, state.frozen["heatmap"].state_dict(),
                         state.frozen["rot_heatmap"].state_dict(),
                         state.net.state_dict(), bf16=True, int8=False,
                         device=dp.device)
        pred.shard(dp.world // 2, num_model=2,
                   devices=[dp.device] * (dp.world // 2 * 2))
        poses = pred(np.zeros((dp.world, 2, cfg.image_size,
                               cfg.image_size, 3), np.float32))
        assert np.isfinite(poses).all()
        note = (f" serving_dp{dp.world // 2}xtp2_pose_norm="
                f"{float(np.abs(poses).mean()):.4f}")
    print(f"dryrun rank {dp.rank}/{dp.world} ok: losses={losses} "
          f"eval_mpjpe={float(mpjpe.mean()):.4f}{note}", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _args(argv)
    if args.rank is None:
        return launch(argv)
    _rank_main(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
