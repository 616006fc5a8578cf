"""The port's tensor-parallel serving against the JAX package's, on the
CPU at a small size (4 joints, 64 x 64 stereo RGB, 16 x 16 maps, lifter
hidden 32, Grid-ViT 1024 x 3 x 8 heads): the split rules against
`parallel/tp.py:lifter_tp_shardings` for every leaf, and
`Predictor.shard(2, num_model=2)` over ``devices=["cpu"] * 4`` against
JAX's `Predictor.shard(2, num_model=2)` on conftest's virtual CPU
devices, in f32, bf16 and calibrated int8, at a batch the data split
divides and a ragged one. Budgets: tests/test_torch_predictor.py (`TOL`,
docs/PARITY_TABLE.md)."""

import warnings

import jax
import numpy as np
import pytest
import torch

from egotap_tpu.core.config import Config as JaxConfig
from egotap_tpu.parallel.mesh import make_mesh
from egotap_tpu.parallel.tp import lifter_tp_shardings
from egotap_tpu.serving import Predictor as JaxPredictor
from egotap_tpu_torch.compat.from_jax import (install_jax_scales,
                                              port_module_name)
from egotap_tpu_torch.models.vit import ViTBlock
from egotap_tpu_torch.ops.quant import Calibrated
from egotap_tpu_torch.parallel.tp import TensorParallelBlock, split_dim
from egotap_tpu_torch.serving import Predictor, serving_config
from tests.test_torch_compat import lifter_vars
from tests.test_torch_predictor import SMALL, TOL, weights  # noqa: F401

# int8, the port's sharded predictor against JAX's under the same static
# scales: f32 summation order flips a few codes, which cascade through
# the lifter (tests/test_torch_quant.py); the int8 budget of the card's
# serving check
INT8_TOL = 1e-1


@pytest.mark.parametrize("num_model", [2, 3, 4])
def test_split_rules_match_jax(num_model):
    """For every lifter leaf, the dim the port splits equals the dim of
    JAX's `lifter_tp_shardings` spec in the torch layout."""
    variables = lifter_vars(res=16, seed=2)
    mesh = make_mesh(num_data=1, num_model=num_model)
    specs = lifter_tp_shardings(variables, mesh)["params"]
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: hasattr(x, "spec"))[0]
    shapes = dict(jax.tree_util.tree_flatten_with_path(
        variables["params"])[0])
    checked = 0
    for path, sharding in flat:
        names = tuple(k.key for k in path)
        leaf = {"kernel": "weight", "bias": "bias"}.get(names[-1])
        spec = tuple(sharding.spec)
        want = None
        if "model" in spec:
            kernel = names[-1] == "kernel"
            want = {(None, "model"): 0, ("model", None): 1,
                    ("model",): 0}[spec]
            assert kernel or spec == ("model",)
        try:
            module = port_module_name(names[:-1])
        except (KeyError, IndexError):
            assert want is None, names
            continue
        if ".encoder.layer." in module and leaf is not None:
            inner = module.split(".encoder.layer.")[1].split(".", 1)[1]
            shape = np.shape(shapes[path])
            torch_shape = shape[::-1] if len(shape) == 2 else shape
            assert split_dim(inner, leaf, torch_shape, num_model) == want, \
                (names, spec)
            checked += 1
        else:
            assert want is None, names
    assert checked >= 18                     # 6 modules x 3 blocks


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test files run in parallel processes, and
    PyTorch's default of a thread per core in each of them oversubscribes
    the cores (as tests/test_torch_loop.py does)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_sharded(variables, bf16, int8, calib=None):
    cfg = JaxConfig(joint_preset="UnrealEgo", model="egotap_autoencoder",
                    heatmap_type="sin", skel_layer="PU",
                    patched_heatmap_ae=True, **SMALL).derive()
    pred = JaxPredictor(cfg, *variables, bf16=bf16, int8=int8)
    if calib is not None:
        pred.calibrate(calib)
    return pred.shard(2, num_model=2)


def _port(states, bf16=False, int8=False):
    return Predictor(serving_config(**SMALL), *states, bf16=bf16, int8=int8,
                     device="cpu")


@pytest.fixture(scope="module")
def f32_predictors(weights):  # noqa: F811
    """JAX's sharded f32 predictor and the port's, unsharded and sharded
    (built once: a ragged batch of 3 pads to JAX's compiled 4)."""
    jax_vars, states = weights
    return (_jax_sharded(jax_vars, bf16=False, int8=False), _port(states),
            _port(states).shard(2, num_model=2, devices=["cpu"] * 4))


@pytest.mark.parametrize("batch", [4, 3])
def test_shard_f32_matches_jax(f32_predictors, batch):
    """2 data x 2 model shards in f32, at a batch the data split divides
    and a ragged one: within 1e-5 of max of JAX's sharded predictor and
    of the port's unsharded one."""
    jax_pred, single, pred = f32_predictors
    rgb = np.random.default_rng(batch).standard_normal(
        (batch, 2, 64, 64, 3)).astype(np.float32)
    ref = jax_pred(rgb)
    tp_block = pred._replicas[0][1][2].pos_heatmap_encoder.vit.encoder \
        .layer[0]
    assert tp_block.split_attention and tp_block.split_mlp
    assert tp_block.parts["attention.attention.query"][0].weight.shape == \
        (512, 1024)
    got, want = pred(rgb), single(rgb)
    assert got.shape == ref.shape == (batch, 5, 3)
    assert np.abs(got - ref).max() <= TOL["float32"] * np.abs(ref).max()
    assert np.abs(got - want).max() <= TOL["float32"] * np.abs(want).max()
    if batch % 2:
        with pytest.raises(ValueError, match="not divisible"):
            pred(rgb, pad_ragged=False)


def test_shard_bf16_matches_unsharded(weights):  # noqa: F811
    _, states = weights
    rgb = np.random.default_rng(1).standard_normal(
        (4, 2, 64, 64, 3)).astype(np.float32)
    want = _port(states, bf16=True)(rgb)
    got = _port(states, bf16=True).shard(
        2, num_model=2, devices=["cpu"] * 4)(rgb)
    assert np.abs(got - want).max() <= TOL["bfloat16"] * np.abs(want).max()


def _scales(nets):
    return [m.a_scale for net in nets for m in net.modules()
            if isinstance(m, Calibrated) and m.a_scale is not None]


def test_shard_int8_matches_jax(weights):  # noqa: F811
    """Calibrated int8 (f32 compute), the scales held: JAX's static
    scales installed in the port, then `shard` again to re-place them.
    The sharded port equals the unsharded port (int32 partial sums are
    exact; within 1e-6 of max) and is within INT8_TOL of JAX's sharded
    predictor. `calibrate` after `shard` gives every replica the new
    static scales."""
    jax_vars, states = weights
    rgb = np.random.default_rng(2).standard_normal(
        (2, 2, 64, 64, 3)).astype(np.float32)
    calib = [rgb + 0.1 * np.random.default_rng(10).standard_normal(
        rgb.shape).astype(np.float32)]
    jax_pred = _jax_sharded(jax_vars, bf16=False, int8=True, calib=calib)
    ref = jax_pred(rgb)
    single = _port(states, int8=True)
    sharded = _port(states, int8=True).shard(2, num_model=2,
                                             devices=["cpu"] * 4)
    for pred in (single, sharded):
        for net, variables in zip(pred.nets, jax_pred._vars):
            install_jax_scales(net, jax.device_get(variables["qparams"]))
    sharded.shard(2, num_model=2, devices=["cpu"] * 4)   # re-placed
    want, got = single(rgb), sharded(rgb)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert np.abs(got - ref).max() <= INT8_TOL * np.abs(ref).max()
    fresh = _port(states, int8=True).shard(2, num_model=2,
                                           devices=["cpu"] * 4)
    fresh.calibrate(calib)
    base = [float(a) for a in _scales(fresh.nets)]
    assert base
    for _, nets in fresh._replicas:
        assert [float(a) for a in _scales(nets)] == base


def test_ragged_dynamic_int8_warns_once(weights):  # noqa: F811
    _, states = weights
    pred = _port(states, int8=True).shard(2, num_model=2,
                                          devices=["cpu"] * 4)
    rgb = np.zeros((3, 2, 64, 64, 3), np.float32)
    with pytest.warns(UserWarning, match="calibrate"):
        assert pred(rgb).shape == (3, 5, 3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pred(rgb)


@pytest.mark.parametrize("int8", [False, True])
def test_shards_own_their_storage(weights, int8):  # noqa: F811
    """Each device's part of a split weight (float, or int8 after
    quantizing) is a copy of 1 / num_model of it, the home device's too,
    and the module keeps no full weight: tensor parallelism saves
    parameter memory on every device of the group."""
    _, states = weights
    pred = _port(states, int8=int8).shard(2, num_model=2,
                                          devices=["cpu"] * 4)
    full = dict(_port(states).lifter.named_modules())
    blocks = [(name, m) for _, nets in pred._replicas
              for name, m in nets[2].named_modules()
              if isinstance(m, TensorParallelBlock)]
    vit = [m for m in full.values() if isinstance(m, ViTBlock)]
    assert vit and len(blocks) == 2 * len(vit)      # a copy a replica
    for path, block in blocks:
        mods = dict(block.block.named_modules())
        assert block.parts
        for name, parts in block.parts.items():
            whole = full[path].get_submodule(name).weight.numel()
            for part in parts:
                t = part.w_q if int8 else part.weight
                assert t.numel() * 2 == whole
                assert t.untyped_storage().nbytes() == \
                    t.numel() * t.element_size()
            assert mods[name].weight.numel() == 0
            if int8:
                assert mods[name].w_q.numel() == 0


def test_shard_refuses_missing_devices(weights):  # noqa: F811
    _, states = weights
    with pytest.raises(RuntimeError, match="need 4 devices"):
        _port(states).shard(2, num_model=2, devices=["cpu"] * 3)
