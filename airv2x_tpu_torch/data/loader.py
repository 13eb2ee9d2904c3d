"""Real-data loader: dataset -> augmentation -> anchor labels -> prefetch
(counterpart of airv2x_tpu/data/loader.py).

Collates ``AirV2XDataset`` samples into batches as ``data/synthetic.py``'s
``batch_to_torch`` gives them (tensors on ``device``), with the anchor
targets (``ops/anchors.py:assign_targets``) computed on ``device`` and, for
the seg task, the stacked label maps under ``labels``. Epochs are shuffled
and sharded per host as torch's DistributedSampler does, and background
threads prepare the next batches while the caller steps.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from airv2x_tpu_torch.data.augment import DataAugmentor
from airv2x_tpu_torch.data.prefetch import Prefetcher
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.ops.anchors import (
    anchor_standup_boxes, assign_targets, generate_anchor_grid)
from airv2x_tpu_torch.utils.device import resolve_device

SEG_KEYS = ("dynamic_seg_label", "static_seg_label")


def stack(values):
    """Stack one key's per-sample values: arrays into one array, nested
    dicts (the ``cam_<type>`` blocks) leaf by leaf."""
    if isinstance(values[0], dict):
        return {k: np.stack([v[k] for v in values]) for k in values[0]}
    return np.stack(values)


class RealDataLoader:
    """Batches (a dict with ``labels``) from an on-disk dataset."""

    def __init__(self, dataset, hypes: dict, batch_size: int, train: bool = True,
                 seed: int = 0, num_workers: int = 4, host_id: int = 0,
                 num_hosts: int = 1, drop_last: bool = True, device="cuda"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.num_workers = num_workers
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.drop_last = drop_last
        self.device = resolve_device(device)

        anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
        self.anchors = torch.from_numpy(anchors).to(self.device)
        self.standup = torch.from_numpy(anchor_standup_boxes(anchors)).to(
            self.device)
        self.target_args = hypes["postprocess"]["target_args"]
        self.augmentor = DataAugmentor(
            hypes.get("data_augment", []) if train else [], train=train)
        # the reference does not augment intermediate fusion: only on request
        self.augment_enabled = bool(
            hypes.get("train_params", {}).get("augment", False))
        task = hypes.get("task", hypes["model"]["args"].get("task", "det"))
        self.is_seg = task == "seg"

    def __len__(self):
        """Batches per epoch for this host (what ``batches`` yields)."""
        n = -(-len(self.dataset) // self.num_hosts)  # padded equal shards
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _sample(self, idx: int, epoch: int):
        batch, gt = self.dataset.__getitem__(idx, epoch=epoch)
        if self.train and self.augment_enabled:
            rng = np.random.default_rng((self.seed, epoch, idx, 7))
            pts, boxes = self.augmentor(batch["points"], gt["boxes"], rng)
            batch = dict(batch, points=pts.astype(np.float32))
            gt = dict(gt, boxes=boxes.astype(np.float32))
        return batch, gt

    def _collate(self, samples):
        """Stack samples (numpy), move them to the device and attach the
        anchor (and seg) labels; returns (batch, numpy gt)."""
        batches = [s[0] for s in samples]
        gts = [s[1] for s in samples]
        # only keys every sample carries can be stacked
        common = set(batches[0])
        for b in batches[1:]:
            common &= set(b)
        dropped = set(batches[0]) - common - set(SEG_KEYS)
        if dropped:
            logging.getLogger(__name__).warning(
                "collate: dropping keys missing in some samples: %s",
                sorted(dropped))
        batch = batch_to_torch(
            {k: stack([b[k] for b in batches])
             for k in sorted(common) if k not in SEG_KEYS}, self.device)
        gt = {k: np.stack([g[k] for g in gts]) for k in gts[0]}

        dev = self.device
        tgts = [assign_targets(
            torch.from_numpy(g["boxes"]).to(dev),
            torch.from_numpy(g["mask"]).to(dev),
            torch.from_numpy(g["classes"]).to(dev),
            self.anchors, self.standup,
            pos_threshold=self.target_args["pos_threshold"],
            neg_threshold=self.target_args["neg_threshold"]) for g in gts]
        labels = {k: torch.stack([getattr(t, k) for t in tgts])
                  for k in ("pos_equal_one", "neg_equal_one", "targets")}
        labels["class_ids"] = torch.stack([t.cls_labels for t in tgts])
        if self.is_seg:
            for k in SEG_KEYS:
                if all(k in b for b in batches):
                    labels[k] = torch.from_numpy(np.stack(
                        [b[k] for b in batches]).astype(np.int32)).to(dev)
        batch["labels"] = labels
        return batch, gt

    def epoch_indices(self, epoch: int):
        """This host's (shuffled, in training) indices of one epoch, padded
        by cyclic repetition to equal shards as torch's DistributedSampler
        does, so that every host takes the same number of steps."""
        n = len(self.dataset)
        order = (np.random.default_rng((self.seed, epoch)).permutation(n)
                 if self.train else np.arange(n))
        per_host = -(-n // self.num_hosts)
        if per_host * self.num_hosts != n:
            order = np.resize(order, per_host * self.num_hosts)
        return order[self.host_id::self.num_hosts].tolist()

    def batches(self, epoch: int = 0, with_gt: bool = False):
        """Yield collated batches (with the numpy gt when ``with_gt``),
        prepared by background workers."""
        idxs = self.epoch_indices(epoch)
        nb = (len(idxs) // self.batch_size if self.drop_last
              else -(-len(idxs) // self.batch_size))
        groups = [idxs[i * self.batch_size:(i + 1) * self.batch_size]
                  for i in range(nb)]
        groups = [g for g in groups if g]

        def make(group):
            return self._collate([self._sample(i, epoch) for i in group])

        pf = Prefetcher(make, groups, num_workers=self.num_workers,
                        buffer_size=max(2, self.num_workers))
        for batch, gt in pf:
            yield (batch, gt) if with_gt else batch
