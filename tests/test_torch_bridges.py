"""The port's bridges for a trained model against the JAX package's, at a
small size (4 joints, 64 x 64 stereo RGB, 16 x 16 maps, resnet18
heatmap nets, lifter hidden 32, Grid-ViT 1024 x 3): `Predictor.
from_checkpoint` against `from_orbax`, `compat.reference.
export_reference_checkpoints`, the reference-optimizer resume and
`load_partial_weights` against `compat/export.py` and
`train/state.py:merge_partial_weights`.

The JAX states are built from seeded variables (`tests/test_torch_compat`)
and carried into the port by `compat.from_jax.task_state_from_jax`; the
reference optimizer is a CPU `torch.optim` over the port net's
``parameters()`` (`tests/golden` cannot be rebuilt here). Budgets:
docs/PARITY_TABLE.md (f32 forward 1e-5 of max, "Backward path" 1e-4)."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egotap_tpu.compat import export as jax_export
from egotap_tpu.compat.convert import convert_lifter
from egotap_tpu.compat.torch_loader import load_torch_checkpoint
from egotap_tpu.core.config import Config as JaxConfig
from egotap_tpu.serving import Predictor as JaxPredictor
from egotap_tpu.train import optim as jax_optim
from egotap_tpu.train import state as jax_state
from egotap_tpu_torch.compat import reference
from egotap_tpu_torch.compat.from_jax import (lifter_state_dict,
                                              port_module_name,
                                              task_state_from_jax)
from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.serving import Predictor
from egotap_tpu_torch.train import state as state_lib
from egotap_tpu_torch.train.tasks import LifterTask
from tests.test_torch_compat import heatmap_vars, lifter_vars

SMALL = dict(num_heatmap=4, num_rot_heatmap=4, ae_hidden_size=32,
             load_size_heatmap=(16, 16), heatmap_type="sin",
             skel_layer="PU", optimizer_type="AdamW", lr=1e-3,
             weight_decay=1e-2, lr_policy="lambda", niter=100,
             niter_decay=100)
POSE_TOL = 1e-5        # f32 pose, relative to max|pose|
PARAM_ATOL = 1e-4      # parameters after a step (PARITY_TABLE backward)


def _configs():
    return (Config(**SMALL).derive(),
            JaxConfig(patched_heatmap_ae=True, **SMALL).derive())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test files run in parallel processes, and
    PyTorch's default of a thread per core in each of them oversubscribes
    the cores (as tests/test_torch_loop.py does)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tmp_path(tmp_path):
    """Removed when the test ends: checkpoints and exports."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_lifter_state():
    """A JAX stage-2 TrainState of seeded variables and AdamW state."""
    hv, rv, lv = heatmap_vars(4, 64), heatmap_vars(8, 64, seed=1), \
        lifter_vars(res=16, seed=2)
    _, jcfg = _configs()
    params = jax.tree.map(jnp.asarray, lv["params"])
    opt_state = jax_optim.make_optimizer(jcfg, 10).init(params)
    return jax_state.TrainState(
        step=jnp.asarray(3), params=params,
        batch_stats=jax.tree.map(jnp.asarray, lv["batch_stats"]),
        opt_state=opt_state,
        frozen={"heatmap": hv, "rot_heatmap": rv})


@pytest.fixture(scope="module")
def port_state(jax_lifter_state):
    cfg, _ = _configs()
    return task_state_from_jax(jax_lifter_state, cfg, 10, device="cpu")


@pytest.fixture(scope="module")
def rgb():
    return np.random.default_rng(0).standard_normal(
        (2, 2, 64, 64, 3)).astype(np.float32)


def test_from_checkpoint_matches_from_orbax(jax_lifter_state, port_state,
                                            rgb, tmp_path):
    """The same state saved by each package and served by each
    `Predictor` (f32): poses within POSE_TOL of their max; the port's
    pose is bit for bit `LifterTask.eval_step`'s."""
    cfg, jcfg = _configs()
    jax_state.save_checkpoint(str(tmp_path / "jax"), "best",
                              jax_lifter_state)
    ref = JaxPredictor.from_orbax(jcfg, str(tmp_path / "jax"),
                                  bf16=False)(rgb)
    state_lib.save_checkpoint(str(tmp_path / "port"), "best", port_state)
    pred = Predictor.from_checkpoint(cfg, str(tmp_path / "port"),
                                     bf16=False, device="cpu")
    got = pred(rgb)
    assert got.shape == ref.shape == (2, 5, 3)
    assert np.abs(got - ref).max() <= POSE_TOL * np.abs(ref).max()
    task = LifterTask(cfg, device="cpu")
    out = task.eval_step(port_state, {
        "input_rgb": rgb, "gt_local_pose": np.zeros((2, 5, 3), np.float32)})
    np.testing.assert_array_equal(out["pred_pose"].numpy(), got)


def _assert_same_files(ours, ref):
    """Two lists of .pth files: the same names, keys in the same order,
    the same dtypes and bit-equal tensors."""
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in ref]
    for a, b in zip(ours, ref):
        sa = torch.load(a, weights_only=True)
        sb = torch.load(b, weights_only=True)
        assert list(sa) == list(sb), os.path.basename(a)
        for k in sb:
            assert sa[k].dtype == sb[k].dtype, k
            assert torch.equal(sa[k], sb[k]), k


def test_export_matches_jax_lifter(jax_lifter_state, port_state, tmp_path):
    ours = reference.export_reference_checkpoints(port_state,
                                                  str(tmp_path / "port"))
    ref = jax_export.export_reference_checkpoints(jax_lifter_state,
                                                  str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in ours] == [
        "best_net_AutoEncoder.pth", "best_net_HeatMap.pth",
        "best_net_RotHeatMap.pth"]
    _assert_same_files(ours, ref)
    nbt = torch.load(ours[1], weights_only=True)[
        "backbone.backbone.backbone.bn1.num_batches_tracked"]
    assert nbt.dtype == torch.int64


def test_export_matches_jax_heatmap(tmp_path):
    """A stage-1 state exports ``{tag}_net_HeatMap.pth`` alone."""
    hv = heatmap_vars(4, 64)
    cfg = Config(model="heatmap_shared", num_heatmap=4, num_rot_heatmap=0,
                 heatmap_type="none", load_size_heatmap=(16, 16)).derive()
    jstate = jax_state.TrainState(
        step=jnp.asarray(0), params=hv["params"],
        batch_stats=hv["batch_stats"], opt_state=(), frozen={})
    state = task_state_from_jax(jstate, cfg, 1, device="cpu")
    ours = reference.export_reference_checkpoints(state, str(tmp_path / "p"),
                                                  tag="7")
    ref = jax_export.export_reference_checkpoints(jstate, str(tmp_path / "j"),
                                                  tag="7")
    assert [os.path.basename(p) for p in ours] == ["7_net_HeatMap.pth"]
    _assert_same_files(ours, ref)


def _torch_reference_run(net, steps, lr, eps, wd, seed, skip=()):
    """A reference-style optimizer: torch AdamW over ``net.parameters()``
    stepped ``steps`` times with seeded gradients (none for the
    parameters named in ``skip``, as for the reference's unused ones),
    and a LambdaLR stepped once an epoch. Returns (optimizer state_dict,
    scheduler state_dict, the optimizer)."""
    opt = torch.optim.AdamW(net.parameters(), lr=lr, eps=eps,
                            weight_decay=wd)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda e: 1.0)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for n, p in net.named_parameters():
            p.grad = None if n in skip else \
                torch.randn(p.shape, generator=gen) * 1e-2
        opt.step()
    sched.step()
    return opt.state_dict(), sched.state_dict(), opt


UNUSED = ("pos_heatmap_encoder.vit.embeddings.cls_token",
          "pos_heatmap_encoder.vit.pooler.dense.weight",
          "pos_heatmap_encoder.vit.pooler.dense.bias")


@pytest.fixture(scope="module")
def resumed(port_state, tmp_path_factory):
    """The torch fixture (2 AdamW steps) written as .pth files, and the
    port's and JAX's resumes from them."""
    cfg, jcfg = _configs()
    net = LifterTask(cfg, device="cpu").init_state(0, 10).net
    net.load_state_dict(port_state.net.state_dict())
    osd, ssd, topt = _torch_reference_run(net, 2, cfg.lr, cfg.opt_eps,
                                             cfg.weight_decay, 5, UNUSED)
    d = tmp_path_factory.mktemp("ref")
    paths = {k: str(d / f"best_{k}.pth") for k in ("optim_0", "net", "sched")}
    torch.save(osd, paths["optim_0"])
    torch.save(ssd, paths["sched"])
    torch.save(reference.reference_state_dict(net), paths["net"])
    # the port: a fresh state of the same weights, resumed
    state = LifterTask(cfg, device="cpu").init_state(0, 10)
    state.net.load_state_dict(torch.load(paths["net"], weights_only=True))
    count, step = reference.load_reference_optimizer(
        state.opt, state.net, torch.load(paths["optim_0"], weights_only=True),
        torch.load(paths["sched"], weights_only=True), cfg.lr_policy, 10)
    # JAX, from the same files
    params = jax.tree.map(jnp.asarray, convert_lifter(
        load_torch_checkpoint(paths["net"]))["params"])
    tx = jax_optim.make_optimizer(jcfg, 10)
    jopt, jcount = jax_export.load_reference_optimizer(
        paths["optim_0"], paths["net"], params, tx.init(params))
    yield dict(cfg=cfg, net=net, state=state, count=count, step=step,
               topt=topt, tx=tx, jopt=jopt, jcount=jcount, params=params,
               paths=paths)
    shutil.rmtree(d, ignore_errors=True)


def _port_layout(tree):
    """A JAX lifter params-shaped tree in the port's key layout."""
    stats = lifter_vars(res=16, seed=2)["batch_stats"]
    return lifter_state_dict({"params": jax.tree.map(np.asarray, tree),
                              "batch_stats": stats})


def _adam_trees(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


def test_reference_optimizer_moments_match_jax(resumed):
    """Both resumes give torch's moments bit for bit (zero for the
    parameters torch never stepped) and torch's step count."""
    r = resumed
    adam = _adam_trees(r["jopt"])
    assert r["count"] == r["jcount"] == int(adam.count) == 2
    assert r["step"] == 10                     # LambdaLR at epoch 1
    for field, jtree in (("mu", adam.mu), ("nu", adam.nu)):
        want = _port_layout(jtree)
        mine = r["state"].opt.trees[field]
        torch_key = {"mu": "exp_avg", "nu": "exp_avg_sq"}[field]
        for name, p in r["net"].named_parameters():
            st = r["topt"].state.get(p)
            expect = (torch.zeros_like(p) if st is None
                      else st[torch_key])
            assert torch.equal(mine[name], expect), (field, name)
            if name in want:
                assert torch.equal(mine[name], want[name]), (field, name)
        for name in UNUSED:
            assert not mine[name].any()


def test_reference_optimizer_next_step_matches(resumed):
    """One more step from each resume with the same gradient: the port's
    against JAX's and against torch's own third step, within the
    backward budget."""
    r = resumed
    gen = torch.Generator().manual_seed(9)
    grads = {n: torch.randn(p.shape, generator=gen) * 1e-2
             for n, p in r["state"].net.named_parameters()}
    for n in UNUSED:
        grads[n] = None
    params = dict(r["state"].net.named_parameters())
    r["state"].opt.step(params, grads)
    for n, p in r["net"].named_parameters():
        p.grad = grads[n]
    r["topt"].step()
    for n, p in r["net"].named_parameters():
        err = float((params[n] - p).detach().abs().max())
        assert err <= PARAM_ATOL, (n, err)
    # JAX: the same gradients in its layout (zeros for the buffers)
    full = {k: (grads.get(k) if grads.get(k) is not None
                else torch.zeros_like(v)).numpy()
            for k, v in r["state"].net.state_dict().items()}
    jgrads = jax.tree.map(jnp.asarray, convert_lifter(full)["params"])
    updates, _ = r["tx"].update(jgrads, r["jopt"], r["params"])
    want = _port_layout(optax.apply_updates(r["params"], updates))
    for n, p in params.items():
        if n not in UNUSED:
            err = float((p - want[n]).abs().max())
            assert err <= PARAM_ATOL, (n, err)


def test_reference_optimizer_rejects_shifted_moments(resumed):
    """A faulty control: the torch state mapped one position late (each
    parameter given its predecessor's moments) is caught by shape or by
    value."""
    r = resumed
    right, shifted = (LifterTask(r["cfg"], device="cpu").init_state(0, 10)
                      for _ in range(2))
    osd = torch.load(r["paths"]["optim_0"], weights_only=True)
    reference.load_reference_optimizer(right.opt, right.net, osd)
    order = osd["param_groups"][0]["params"]
    osd["param_groups"][0]["params"] = order[-1:] + order[:-1]
    try:
        reference.load_reference_optimizer(shifted.opt, shifted.net, osd)
    except ValueError as e:
        assert "shape" in str(e)
        return
    mu, want = shifted.opt.trees["mu"], right.opt.trees["mu"]
    assert any(not torch.equal(mu[n], want[n]) for n in mu)


def test_reference_optimizer_rejects_non_uniform_steps(resumed):
    r = resumed
    osd = torch.load(r["paths"]["optim_0"], weights_only=True)
    first = next(iter(osd["state"]))
    osd["state"][first]["step"] = torch.tensor(5.0)
    with pytest.raises(ValueError, match="non-uniform"):
        reference.load_reference_optimizer(r["state"].opt, r["state"].net,
                                           osd)
    bad = str(r["paths"]["optim_0"]) + ".bad.pth"
    torch.save(osd, bad)
    with pytest.raises(ValueError, match="non-uniform"):
        jax_export.load_reference_optimizer(
            bad, r["paths"]["net"], r["params"], r["tx"].init(r["params"]))


@pytest.mark.parametrize("parts", [("pos_heatmap_encoder",),
                                   ("fc1", "pose_mlp")])
def test_partial_weights_match_jax(parts, tmp_path):
    """Merge the ``parts`` of one seeded lifter into another, in the port
    by torch keys and in JAX by flax paths (mapped through
    `port_module_name`): the same tensors load, and the merged nets are
    equal tensor for tensor."""
    target, source = lifter_vars(res=16, seed=2), lifter_vars(res=16, seed=3)
    jax_parts = [{"pos_heatmap_encoder": "pos_encoder"}.get(p, p)
                 for p in parts]
    merged, loaded = jax_state.merge_partial_weights(target, source,
                                                     jax_parts)
    cfg, _ = _configs()
    net = LifterTask(cfg, device="cpu").init_state(0, 1).net
    net.load_state_dict(lifter_state_dict(target))
    src = str(tmp_path / "source.pth")
    torch.save({"module." + k: v for k, v in
                lifter_state_dict(source).items()}, src)
    keys = reference.load_partial_weights(net, src, parts)
    assert keys and all(any(p in k for p in parts) for k in keys)
    want = lifter_state_dict(jax.tree.map(np.asarray, merged))
    got = net.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # the JAX paths loaded, by port module, against the port's keys
    jax_modules = set()
    for path in loaded:
        names = path.split("/")
        if names[0] != "params":
            continue
        try:
            jax_modules.add(port_module_name(tuple(names[1:-1])))
        except (KeyError, IndexError):
            continue
    port_modules = {k.rsplit(".", 1)[0] for k in keys}
    assert jax_modules and jax_modules <= port_modules


def test_partial_weights_from_a_port_checkpoint(port_state, tmp_path):
    """A ``ckpt_*`` directory is a source too; a key of another shape
    keeps the target's value."""
    state_lib.save_checkpoint(str(tmp_path), "best", port_state)
    cfg, _ = _configs()
    fresh = LifterTask(cfg, device="cpu").init_state(1, 1).net
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    keys = reference.load_partial_weights(fresh, str(tmp_path / "ckpt_best"),
                                          ["pos_heatmap_encoder"])
    saved = port_state.net.state_dict()
    for k, v in fresh.state_dict().items():
        want = saved[k] if k in keys else before[k]
        assert torch.equal(v, want), k
    assert set(keys) == {k for k in saved if "pos_heatmap_encoder" in k}
    bad = {k: (v[:1] if k.endswith("fc1.fc.weight") else v)
           for k, v in saved.items()}
    keys = reference.merge_partial_weights(fresh, bad, ["fc1"])
    assert not any(k.endswith("fc1.fc.weight") for k in keys) and keys
