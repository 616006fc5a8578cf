"""The host loaders, and the batch preprocess: a raw batch in, the model
feed with its targets out, on the batch's device.

Counterpart of `egotap_tpu/data/pipeline.py:make_device_preprocess`
(reference dataloader/data_loader.py:76-215, which renders the targets
per frame on the host):
  * joint heatmaps from the 2D joints [1:], peak-normalized   (:90-95)
  * limb line maps x2 and per-side pixel lengths              (:123-127)
  * sin-type (cos, sin) channels from the LEFT camera's theta (:193-199)
  * tail-slicing to num_heatmap / num_rot_heatmap             (:149-164)
  * the head-relative pose when the root is not estimated     (:153-157)
  * plength tiled limb_dim times                              (:210-214)

The loaders are the port's own copy of the JAX package's (one process;
`egotap_tpu/data/pipeline.py:117-351`): `BatchLoader` reads `.npy` frames
in threads, `PackedBatchLoader` gathers batches from a packed split
(`native/recordio.py`), `PrefetchLoader` keeps a few batches staged in a
background thread. Eval batches are padded to the batch size with a
validity mask (``mask``); batches are numpy dicts plus their frame
``paths``. `make_loader` prefers a packed split: a pack that exists but
cannot be read raises, and only a missing pack falls back to `.npy`.
"""

from __future__ import annotations

import itertools
import os
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.device import set_f32_numerics
from egotap_tpu_torch.core.skeleton import get_skeleton
from egotap_tpu_torch.data import device_render as dr
from egotap_tpu_torch.data.dataset import FrameDataset
from egotap_tpu_torch.native import recordio

Batch = Dict[str, torch.Tensor]


def _resize(rgb: torch.Tensor, size: int) -> torch.Tensor:
    """(B, h, w, 3) -> (B, size, size, 3) as ``jax.image.resize(...,
    "bilinear")`` resizes: half-pixel centres, a triangle filter widened
    by the scale when it shrinks the image (antialiasing), weights that
    fall outside the image dropped and the rest renormalised."""
    out = F.interpolate(rgb.permute(0, 3, 1, 2), size=(size, size),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).contiguous()


def make_device_preprocess(cfg: Config) -> Callable[[Batch], Batch]:
    """The raw batch -> model-feed transform of ``cfg``.

    The raw batch holds ``input_rgb_left`` / ``_right`` (B, h, w, 3),
    ``gt_camera_2d_left`` / ``_right`` (B, J, 2) in 1024-space,
    ``gt_local_pose`` (B, J, 3), ``gt_local_rot``, ``gt_pelvis_left`` /
    ``_right`` (B, 3) and ``mask`` (B,), all on one device. The feed:
    ``input_rgb`` (B, 2, S, S, 3) f32 at the config's image size S,
    ``gt_heatmap_{side}`` (B, r, r, num_heatmap), and for limb configs
    ``gt_limb_heatmap_{side}`` (B, r, r, num_rot_heatmap * limb_dim),
    ``gt_plength_{side}`` and ``gt_limb_theta``, then the pose, rotation,
    pelvis and mask rows."""
    sk = get_skeleton(cfg.joint_preset)
    parents = sk.parents
    res = cfg.heatmap_res
    nh, nr, ld = cfg.num_heatmap, cfg.num_rot_heatmap, cfg.limb_dim
    set_f32_numerics()              # the limb blur's products in full f32

    def preprocess(batch: Batch) -> Batch:
        out: Batch = {}
        rgb_l = batch["input_rgb_left"].float()   # f16-packed splits too
        rgb_r = batch["input_rgb_right"].float()
        if rgb_l.shape[1] != cfg.image_size:
            rgb_l = _resize(rgb_l, cfg.image_size)
            rgb_r = _resize(rgb_r, cfg.image_size)
        out["input_rgb"] = torch.stack([rgb_l, rgb_r], dim=1)

        pose = batch["gt_local_pose"]                    # (B, J, 3)
        pelvis_l = batch["gt_pelvis_left"]
        pelvis_r = batch["gt_pelvis_right"]

        if nh > 0:
            for side in ("left", "right"):
                hm = dr.render_joint_heatmaps(
                    batch[f"gt_camera_2d_{side}"][:, 1:], res)
                hm = hm[:, -nh:] if nh < sk.num_heatmaps else hm
                out[f"gt_heatmap_{side}"] = hm.permute(0, 2, 3, 1)

        if nr > 0 and ld > 0:
            pts3d_l = pose + pelvis_l[:, None, :]
            pts3d_r = pose + pelvis_r[:, None, :]
            theta = dr.limb_theta(pts3d_l, parents)      # (B, J-1), LEFT
            for side in ("left", "right"):
                raw, plen = dr.render_limb_heatmaps(
                    batch[f"gt_camera_2d_{side}"], parents, res)
                raw = raw * 2.0                          # (:127) x2 scale
                raw, plen, th = raw[:, -nr:], plen[:, -nr:], theta[:, -nr:]
                if cfg.heatmap_type == "sin":
                    limb = torch.cat(dr.sin_limb_heatmaps(raw, th), dim=1)
                else:                                    # "limb"
                    limb = raw
                out[f"gt_limb_heatmap_{side}"] = limb.permute(0, 2, 3, 1)
                out[f"gt_plength_{side}"] = plen.repeat(1, ld)
            out["gt_limb_theta"] = theta[:, -nr:]

        if cfg.joint_preset == "UnrealEgo" and not cfg.estimate_head:
            pose = pose + pelvis_l[:, None, :]
            pelvis_l = torch.zeros_like(pelvis_l)
            pelvis_r = torch.zeros_like(pelvis_r)

        out["gt_local_pose"] = pose if cfg.estimate_head else pose[:, 1:]
        out["gt_local_rot"] = batch["gt_local_rot"]
        out["gt_pelvis_left"] = pelvis_l
        out["gt_pelvis_right"] = pelvis_r
        out["mask"] = batch["mask"]
        return out

    return preprocess


def _stack_batch(frames, batch_size: int) -> Dict[str, np.ndarray]:
    """Stack frame dicts; pad to batch_size with the last frame and a
    validity mask."""
    n = len(frames)
    batch: Dict[str, np.ndarray] = {}
    for k in frames[0]:
        if k == "path":
            continue
        arr = np.stack([f[k] for f in frames])
        if n < batch_size:
            pad = np.repeat(arr[-1:], batch_size - n, axis=0)
            arr = np.concatenate([arr, pad], axis=0)
        batch[k] = arr
    batch["mask"] = (np.arange(batch_size) < n).astype(np.float32)
    batch["paths"] = [f["path"] for f in frames]  # type: ignore[assignment]
    return batch


def _num_batches(n: int, batch_size: int, drop_last: bool) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


class BatchLoader:
    """Shuffling / padding batch iterator over `.npy` frames, read in
    threads.

    train: shuffled, drop_last (reference dataloader_full,
    dataloader/data_loader.py:41-63); eval: ordered, the final batch
    padded and masked so that shapes stay fixed."""

    def __init__(self, dataset: FrameDataset, batch_size: int,
                 shuffle: bool, drop_last: bool, num_threads: int = 2,
                 seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.rng = np.random.default_rng(seed)
        self.indices = np.arange(len(dataset))

    def __len__(self) -> int:
        return _num_batches(len(self.indices), self.batch_size,
                            self.drop_last)

    def _index_batches(self):
        idx = self.indices.copy()
        if self.shuffle:
            self.rng.shuffle(idx)
        for i in range(len(self)):
            yield idx[i * self.batch_size:(i + 1) * self.batch_size]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        from concurrent.futures import ThreadPoolExecutor

        def load(indices):
            return _stack_batch([self.ds[i] for i in indices],
                                self.batch_size)

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            gen = self._index_batches()
            futures = [pool.submit(load, sel) for sel in
                       itertools.islice(gen, 2 * self.num_threads)]
            while futures:
                batch = futures.pop(0).result()
                sel = next(gen, None)
                if sel is not None:
                    futures.append(pool.submit(load, sel))
                yield batch


class PrefetchLoader:
    """Background-thread prefetch over any batch iterable, at most
    ``depth`` batches ahead.

    The packed reader's gather is synchronous, and the main thread also
    blocks on loss reads, validation and checkpoint writes, when an
    unwrapped loader sits idle. A daemon thread keeps batches staged
    (numpy work only: the native gather and np.load release the GIL).
    Each __iter__ starts a fresh thread; abandoning the iterator mid-epoch
    (a watchdog break) stops the thread promptly."""

    def __init__(self, inner, depth: int = 2):
        self._inner = inner
        self._depth = max(1, int(depth))

    def __len__(self) -> int:
        return len(self._inner)

    def __getattr__(self, name):
        # delegate reader/indices/... to the inner loader; `_inner` itself
        # is looked up here only before __init__ ran (copy, unpickling),
        # where delegating would recurse
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._inner:
                    if not put(b):
                        return
                put(done)
            except BaseException as e:  # re-raised on the consumer side
                put(e)

        t = threading.Thread(target=worker, daemon=True,
                             name="egotap-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


class PackedBatchLoader:
    """Batch iterator over a packed .egr split: one native gather a batch
    (no per-frame Python work). Same interface and semantics as
    `BatchLoader`."""

    def __init__(self, reader, batch_size: int, shuffle: bool,
                 drop_last: bool, indices: Optional[np.ndarray] = None,
                 seed: int = 0):
        self.reader = reader
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.indices = (np.arange(reader.num_records)
                        if indices is None else np.asarray(indices))
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return _num_batches(len(self.indices), self.batch_size,
                            self.drop_last)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self.indices.copy()
        if self.shuffle:
            self.rng.shuffle(idx)
        paths = self.reader.paths
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            n = len(sel)
            if n < self.batch_size:  # pad with the last frame + mask
                sel = np.concatenate(
                    [sel, np.repeat(sel[-1:], self.batch_size - n)])
            batch = self.reader.gather(sel)
            batch["mask"] = (np.arange(self.batch_size) < n).astype(np.float32)
            batch["paths"] = ([paths[i] for i in sel[:n]] if paths
                              else [str(i) for i in sel[:n]])
            yield batch


def make_loader(cfg: Config, mode: str, category_id: Optional[str] = None):
    """The loader of one split (optionally one motion category): the
    packed split when `native/recordio.py:pack_split` wrote one (a pack
    that cannot be built or opened raises), else the `.npy` frames.
    Training batches are shuffled with ``cfg.seed`` and drop the last
    partial batch; eval batches keep order and pad it."""
    train = mode == "train"
    packed = recordio.packed_path(cfg, mode)
    if os.path.exists(packed):
        reader = recordio.RecordReader(packed, num_threads=cfg.num_threads)
        indices = None
        if category_id is not None:
            if reader.paths is None:
                raise ValueError(f"{packed} has no .paths sidecar; cannot "
                                 "filter by category")
            indices = np.asarray(
                [i for i, p in enumerate(reader.paths)
                 if p.split("/")[-4] == category_id], dtype=np.int64)
        loader = PackedBatchLoader(reader, cfg.batch_size, shuffle=train,
                                   drop_last=train, indices=indices,
                                   seed=cfg.seed)
        if cfg.prefetch_batches > 0:
            return PrefetchLoader(loader, depth=cfg.prefetch_batches)
        return loader
    ds = FrameDataset(cfg, mode, category_id)
    return BatchLoader(ds, cfg.batch_size, shuffle=train, drop_last=train,
                       num_threads=cfg.num_threads, seed=cfg.seed)
