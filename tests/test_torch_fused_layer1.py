"""The port's fused int8 layer1 (egotap_tpu_torch.ops.fused_layer1, the
plain version of kernel D) against the JAX package's
(egotap_tpu.ops.fused_layer1), and the quantized ResNet encoder, fused
and unfused, against the JAX one under the same static scales."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from egotap_tpu.ops import fused_layer1 as jf
from egotap_tpu.ops import quant as jq
from egotap_tpu_torch.compat.from_jax import heatmap_net_from_jax, jax_scales
from egotap_tpu_torch.models.resnet import BasicBlock, ResNetEncoder
from egotap_tpu_torch.ops import fused_layer1 as tf
from egotap_tpu_torch.ops.quant import im2col, int8_matmul, prequantize
from tests.test_fused_layer1 import _block
from tests.test_torch_compat import heatmap_vars

C = 64


def _blocks(seed, n):
    """n JAX BasicBlock parameter dicts and the port's BasicBlocks
    holding the same weights."""
    rng = np.random.default_rng(seed)
    jax_blocks = [_block(rng, C) for _ in range(n)]
    port = []
    for p in jax_blocks:
        blk = BasicBlock(C, C, 1, quant=True)
        sd = {}
        for i in ("1", "2"):
            sd[f"conv{i}.weight"] = np.asarray(p[f"conv{i}"]).transpose(
                3, 2, 0, 1)
            for t, f in (("weight", "scale"), ("bias", "bias"),
                         ("running_mean", "mean"), ("running_var", "var")):
                sd[f"bn{i}.{t}"] = np.asarray(p[f"bn{i}_{f}"])
            sd[f"bn{i}.num_batches_tracked"] = np.asarray(0)
        blk.load_state_dict({k: torch.from_numpy(np.array(a))
                             for k, a in sd.items()})
        port.append(blk)
    return jax_blocks, port


def test_fold_and_pack_match_jax():
    jax_blocks, port = _blocks(0, 2)
    wq, ws, b = jf.pack_blocks(jax_blocks, eps=1e-5)
    got = tf.pack_blocks(port, 1e-5)
    assert got[0].shape == (4, 9 * C, C) and got[0].dtype == torch.int8
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(wq))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ws))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(b))


@pytest.mark.parametrize("n_blocks,h", [(2, 16), (3, 8)])
def test_plain_matches_jax_reference_and_interpret(n_blocks, h):
    jax_blocks, port = _blocks(1, n_blocks)
    packed = jf.pack_blocks(jax_blocks, eps=1e-5)
    x = np.random.default_rng(2).normal(size=(3, h, h, C)).astype(np.float32)
    got = tf.fused_layer1_plain(torch.from_numpy(x),
                                *tf.pack_blocks(port, 1e-5)).numpy()
    # op by op the JAX reference runs the same IEEE operations: equal
    ref = np.asarray(jf.fused_layer1_reference(jnp.asarray(x), *packed))
    np.testing.assert_array_equal(got, ref)
    # the Pallas kernel in interpret mode runs under jit, where XLA
    # multiplies by 1/127 instead of dividing: its own test holds it to
    # the reference within 1e-4, and so is the port
    kern = np.asarray(jf.fused_layer1_int8(jnp.asarray(x), *packed,
                                           interpret=True))
    np.testing.assert_allclose(got, kern, rtol=0, atol=1e-4)


def test_per_image_scales_are_batch_invariant():
    _, port = _blocks(3, 1)
    packed = tf.pack_blocks(port, 1e-5)
    x0 = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 8, 8, C)).astype(np.float32))
    alone = tf.fused_layer1_plain(x0, *packed)
    mixed = tf.fused_layer1_plain(torch.cat([x0, 100 * x0]), *packed)
    torch.testing.assert_close(mixed[:1], alone, rtol=0, atol=0)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    _, port = _blocks(5, 2)
    packed = tf.pack_blocks(port, 1e-5)
    x = torch.randn(2, 8, 8, C, generator=torch.Generator().manual_seed(0))
    before = tf.fused_layer1_int8.launches
    torch.testing.assert_close(tf.fused_layer1_int8(x, *packed),
                               tf.fused_layer1_plain(x, *packed),
                               rtol=0, atol=0)
    assert tf.fused_layer1_int8.launches == before


# Layer by layer against JAX under the same static scales, rel-L2. The
# JAX side runs op by op, the same IEEE operations as the port, and reads
# at most 5e-8 (float rounding of the stem; layers 2-4 equal). JAX's fused
# layer1 kernel runs under jit, where XLA multiplies by 1/127 instead of
# dividing: a per-image scale may then differ in its last bit and flip an
# int8 code by one step (1/127 of the image's scale). The bound allows a
# few such steps, far below a wrong scale or a dropped residual (> 1e-1).
ENCODER_TOL = 1e-3


@pytest.mark.parametrize("fused", [False, True])
def test_encoder_quant_matches_jax(fused):
    v = heatmap_vars(4, 64)
    sub = {col: tree["backbone"] for col, tree in v.items()}
    x = np.random.default_rng(6).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    model = JaxResNetEncoder("resnet18", quant=True, fused_layer1=fused)
    # calibration jitted (only its scales are kept, and given to both
    # sides); the calibrated forward op by op
    _, mut = jax.jit(functools.partial(model.apply, train=False,
                                       mutable=["calib"]))(sub, jnp.asarray(x))
    qparams = jq.merge_qparams(jq.quantize_conv_tree(sub["params"]),
                               jq.amax_to_qparams(mut["calib"]))
    ref = model.apply({**sub, "qparams": qparams}, jnp.asarray(x),
                      train=False)

    trunk = heatmap_net_from_jax(v, device="cpu").backbone.backbone.backbone
    enc = ResNetEncoder("resnet18", quant=True, fused_layer1=fused)
    enc.load_state_dict(trunk.state_dict())
    prefix = "backbone.backbone.backbone."
    scales = jax_scales({"backbone": qparams})
    # the fused layer1 records no static scales, on either side
    assert len(scales) == (15 if fused else 19)
    for name, s in scales.items():
        enc.get_submodule(name[len(prefix):]).a_scale = torch.tensor(s)
    prequantize([enc])
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    for i, (a, b) in enumerate(zip(got[2:], ref[2:]), start=1):
        a, b = a.numpy(), np.asarray(b)
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= ENCODER_TOL, (i, rel)


def cluster_schedule(x, w_q, w_scale, bias, per_band_scale=False,
                     stale_halo=False):
    """Kernel D's cluster schedule (`csrc/fused_layer1.cu`), emulated on
    the CPU: each image's pixels cut into `cluster_geometry`'s runs, one a
    block; per conv each block takes the max of its own pixels, the
    maxima are reduced to the image's (``per_band_scale``: each block
    keeps its own, the fault a cluster design can make), each block
    quantizes only its own pixels, and each block's conv reads the pixels
    it does not own from their owners' codes of this conv
    (``stale_halo``: of the previous conv, zeros before the first)."""
    n, h, w, c = x.shape
    geo = tf.cluster_geometry(h, w)
    pb, cl = geo["pixels"], geo["cluster"]
    owner = torch.arange(h * w) // pb                   # block of each pixel
    act = x.float().reshape(n, h * w, c)
    residual = act
    prev = torch.zeros(n, h * w, c, dtype=torch.int8)
    for conv in range(w_q.shape[0]):
        band_max = torch.stack([act[:, owner == b].abs().amax(dim=(1, 2))
                                for b in range(cl)], dim=1)      # (n, cl)
        if not per_band_scale:
            band_max = band_max.amax(dim=1, keepdim=True).expand(n, cl)
        a_scale = (torch.clamp_min(band_max, 1e-12)
                   / tf.f32_scalar(act, 127.0))[:, owner, None]  # per pixel
        codes = torch.round(act / a_scale).clamp_(-127, 127).to(torch.int8)
        acc = torch.empty(n, h * w, c, dtype=torch.int32)
        for b in range(cl):
            mine = owner == b
            seen = codes if not stale_halo else torch.where(
                mine[None, :, None], codes, prev)
            cols, _ = im2col(seen.reshape(n, h, w, c), 3, 1, 1)
            cols = cols.reshape(n, h * w, -1)[:, mine]
            acc[:, mine] = int8_matmul(cols.reshape(-1, cols.shape[-1]),
                                       w_q[conv].t()).reshape(n, -1, c)
        prev = codes
        out = acc.float() * (a_scale * w_scale[conv]) + bias[conv]
        if conv % 2 == 0:
            act = torch.relu(out)
        else:
            act = torch.relu(out + residual)
            residual = act
    return act.reshape(n, h, w, c).to(x.dtype)


@pytest.mark.parametrize("shape", [(2, 16, 16), (2, 20, 12), (1, 64, 64)])
def test_cluster_schedule_matches_plain(shape):
    """The schedule equals the plain version bit for bit (every image cut
    over several blocks, with a short last run at 20 x 12); one scale per
    block, or a halo from the previous conv's codes, does not."""
    _, port = _blocks(7, 2)
    packed = tf.pack_blocks(port, 1e-5)
    n, h, w = shape
    assert tf.cluster_geometry(h, w)["cluster"] > 1
    ramp = 1 + torch.arange(h * w).reshape(1, h, w, 1) / (h * w)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(n, h, w, C)).astype(np.float32)) * ramp
    ref = tf.fused_layer1_plain(x, *packed)
    torch.testing.assert_close(cluster_schedule(x, *packed), ref,
                               rtol=0, atol=0)
    for fault in ("per_band_scale", "stale_halo"):
        bad = cluster_schedule(x, *packed, **{fault: True})
        assert (bad - ref).abs().max() > 1e-3 * ref.abs().max(), fault


@pytest.mark.parametrize("h,w,pixels,cluster,tile_rows", [
    (64, 64, 256, 16, 6),          # serving: 4 rows a block
    (16, 16, 32, 8, 4), (8, 8, 32, 2, 6), (20, 12, 32, 8, 6),
    (50, 30, 96, 16, 6),           # runs start mid-row, short last run
    (1, 1, 32, 1, 3)])
def test_cluster_geometry(h, w, pixels, cluster, tile_rows):
    geo = tf.cluster_geometry(h, w)
    assert (geo["pixels"], geo["cluster"], geo["tile_rows"]) == (
        pixels, cluster, tile_rows)
    assert (cluster - 1) * pixels < h * w <= cluster * pixels
    assert geo["smem"] <= tf.SMEM_LIMIT


def test_cluster_geometry_refuses_images_off_chip():
    with pytest.raises(NotImplementedError, match="4096"):
        tf.cluster_geometry(65, 64)
    with pytest.raises(NotImplementedError, match="shared memory"):
        tf.cluster_geometry(1, 4096)


def test_kernel_weights_layout_is_kept():
    """[conv][out channel][k] rows, zero padded to the pitch; made once
    per w_q, again after w_q changes in place."""
    _, port = _blocks(9, 2)
    w_q = tf.pack_blocks(port, 1e-5)[0]
    rows = tf.kernel_weights(w_q)
    assert rows.shape == (4, C, tf.WPITCH) and rows.dtype == torch.int8
    assert torch.equal(rows[:, :, :9 * C], w_q.transpose(1, 2))
    assert not rows[:, :, 9 * C:].any()
    assert tf.kernel_weights(w_q) is rows
    w_q[0, 0, 0] = -w_q[0, 0, 0] - 1
    again = tf.kernel_weights(w_q)
    assert again is not rows and again[0, 0, 0] == w_q[0, 0, 0]
