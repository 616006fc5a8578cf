"""The port's EgoTAPLifter (Grid-ViT + limb encoder + skeleton layer +
heads) against the JAX package's, at a small size: J=4 heatmaps, 32x32
heatmaps, hidden 32, ViT width 1024 with 3 layers; every skeleton layer
(PU chain and tree, 1-3 PU layers, the LSTM walks, the pass-throughs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.models.encoders import LimbFCEncoder as JaxLimbFCEncoder
from egotap_tpu.models.lifter import EgoTAPLifter as JaxLifter
from egotap_tpu.models.vit import tile_permutation as jax_tile_permutation
from egotap_tpu_torch.compat.from_jax import lifter_from_jax
from egotap_tpu_torch.models.encoders import LimbFCEncoder
from egotap_tpu_torch.models.vit import tile_permutation
from tests.test_torch_compat import LIFTER_SMALL, lifter_vars

RES = 32
# f32: same math, other summation orders (ViT width 1024 matmuls).
# bf16: both sides run every matmul in bf16 (LN/BN in f32), the port's
# attention and PU chain keep f32 scores/state where the JAX default path
# rounds them to bf16: the pose differs by 1-2% of its scale.
TOL = {"float32": 1e-5, "bfloat16": 4e-2}
# a branching 5-joint tree for the 4 walked joints: 1 and 3 hang off the
# root's child
PARENTS = (0, 0, 1, 1, 2)


@pytest.mark.parametrize("kw", [
    {},
    {"num_joints": 4, "use_global_offset": False},     # EgoCap-style heads
    {"num_rot_heatmap": 3},                            # tail-aligned bridges
    {"skel_layer": "LSTM", "parents": PARENTS},
    {"skel_layer": "LSTMSplit", "parents": PARENTS},
    {"skel_layer": "LSTMNoRel", "parents": PARENTS},
    {"skel_layer": "None"},
    {"skel_layer": "NoneNoRel"},
    {"pu_semantics": "tree", "parents": PARENTS},
    {"num_pu_layers": 1},
    {"num_pu_layers": 3},
], ids=["unrealego", "no_global", "fewer_limbs", "lstm", "lstm_split",
        "lstm_norel", "none", "none_norel", "pu_tree", "pu_1_layer",
        "pu_3_layers"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax(dtype, kw):
    kw_all = {**LIFTER_SMALL, **kw}
    v = lifter_vars(**kw)
    nh, nr = kw_all["num_heatmap"], kw_all.get("num_rot_heatmap", 4)
    x = np.random.default_rng(1).uniform(
        0, 1, (2, RES, RES, nh * 2 + nr * 2 * 2)).astype(np.float32)
    ref = JaxLifter(**kw_all).apply(v, jnp.asarray(x, getattr(jnp, dtype)),
                                    train=False)
    ref = np.asarray(ref, np.float32)
    net = lifter_from_jax(v, 3, device="cpu", heatmap_size=RES, **kw_all)
    with torch.no_grad():
        got = net(torch.from_numpy(x).to(getattr(torch, dtype)))
    got = got.float().numpy()
    assert got.shape == ref.shape == (2, kw_all["num_joints"], 3)
    assert np.abs(got - ref).max() <= TOL[dtype] * np.abs(ref).max()


@pytest.mark.parametrize("t,p", [(3, 2), (6, 4), (2, 1)])
def test_tile_permutation_matches_jax(t, p):
    np.testing.assert_array_equal(tile_permutation(t, p),
                                  jax_tile_permutation(t, p))


def test_limb_encoder_matches_jax():
    v = lifter_vars()
    sub = {col: tree["rot_encoder"] for col, tree in v.items()}
    x = np.random.default_rng(2).standard_normal(
        (2, 8, 2 * RES * RES)).astype(np.float32)
    ref = np.asarray(JaxLimbFCEncoder(hidden_size=32).apply(
        sub, jnp.asarray(x), train=False))
    enc = LimbFCEncoder(2 * RES * RES, 32).eval()
    sd = {}
    for n in ("fc1", "fc2", "fc3"):
        p, s = sub["params"][n], sub["batch_stats"][n]["bn"]
        sd.update({f"{n}.fc.weight": p["fc"]["kernel"].T,
                   f"{n}.fc.bias": p["fc"]["bias"],
                   f"{n}.bn.weight": p["bn"]["scale"],
                   f"{n}.bn.bias": p["bn"]["bias"],
                   f"{n}.bn.running_mean": s["mean"],
                   f"{n}.bn.running_var": s["var"],
                   f"{n}.bn.num_batches_tracked": np.asarray(0)})
    enc.load_state_dict({k: torch.from_numpy(np.array(a))
                         for k, a in sd.items()}, strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_unknown_skel_layer_raises():
    with pytest.raises(ValueError, match="GRU"):
        lifter_from_jax(lifter_vars(), 3, device="cpu", skel_layer="GRU",
                        **LIFTER_SMALL)
