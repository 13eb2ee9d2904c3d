"""Tracking: the appearance-embedding head (on the model's device) and the
Hungarian tracker (on the host), the counterpart of
airv2x_tpu/models/tracking.py.

``TrackingHead`` pools the BEV map per detection and projects the pooled
features to a unit embedding. ``Tracker`` associates the detections of
consecutive frames by Hungarian matching (``scipy`` ``linear_sum_assignment``)
on cosine similarity, and ages out tracks that go unmatched.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment
from torch import nn


class TrackingHead(nn.Module):
    """(H, W, C) BEV features + (N, 5+) boxes -> (N, D) unit embeddings.

    As in the reference, every box pools the whole BEV map (its ROI pooling
    is a placeholder), so every detection of a frame gets one embedding.
    ``Dense_0`` / ``Dense_1`` are flax's names for the two layers.
    """

    FLAX_NAMES = {"dense0": "Dense_0", "dense1": "Dense_1"}

    def __init__(self, in_channels: int, embed_dim: int = 128):
        super().__init__()
        self.dense0 = nn.Linear(in_channels, 256)
        self.dense1 = nn.Linear(256, embed_dim)

    def forward(self, bev_features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        n = boxes.shape[0]
        pooled = bev_features.mean(dim=(0, 1))  # (C,)
        pooled = pooled.to(self.dense0.weight.dtype).expand(n, pooled.shape[0])
        x = self.dense1(torch.relu(self.dense0(pooled)))
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                               min=1e-9)


class Tracker:
    """Host-side track manager (Hungarian association, ageing)."""

    def __init__(self, sim_threshold: float = 0.5, max_age: int = 5):
        self.tracks: list[dict] = []
        self._ids = itertools.count()
        self.sim_threshold = sim_threshold
        self.max_age = max_age

    def update(self, boxes: np.ndarray, embeddings: np.ndarray) -> list[int]:
        """boxes (N, *), embeddings (N, D) -> per-detection track ids."""
        n = len(boxes)
        matches, unmatched = self._associate(embeddings)

        det_tid: dict[int, int] = {}
        new_tracks = []
        matched_track_idx = {t for _, t in matches}

        for det_idx, track_idx in matches:
            tr = self.tracks[track_idx]
            tr.update(embedding=embeddings[det_idx], box=boxes[det_idx], age=0)
            new_tracks.append(tr)
            det_tid[det_idx] = tr["id"]

        for idx in unmatched:
            tr = {"id": next(self._ids), "embedding": embeddings[idx],
                  "box": boxes[idx], "age": 0}
            new_tracks.append(tr)
            det_tid[idx] = tr["id"]

        for i, tr in enumerate(self.tracks):
            if i not in matched_track_idx:
                tr["age"] += 1
                if tr["age"] <= self.max_age:
                    new_tracks.append(tr)

        self.tracks = new_tracks
        return [det_tid[i] for i in range(n)]

    def _associate(self, embeddings: np.ndarray):
        if not self.tracks or len(embeddings) == 0:
            return [], list(range(len(embeddings)))
        track_embeds = np.stack([t["embedding"] for t in self.tracks])
        sim = embeddings @ track_embeds.T  # (N, M)
        rows, cols = linear_sum_assignment(1.0 - sim)
        matches, unmatched = [], set(range(len(embeddings)))
        for r, c in zip(rows, cols):
            if sim[r, c] > self.sim_threshold:
                matches.append((int(r), int(c)))
                unmatched.discard(int(r))
        return matches, sorted(unmatched)


def geometry_embedding(boxes: np.ndarray, lidar_range) -> np.ndarray:
    """(N, 7) boxes -> (N, 8) unit embeddings of their normalised geometry
    (x, y over the range's x span, z / 10, the three sizes / 4, 4 and 8,
    cos and sin of the yaw), which the evaluation CLI's ``--track`` feeds
    the ``Tracker``: ``TrackingHead`` gives every detection of a frame one
    embedding, which cannot tell them apart."""
    span = max(lidar_range[3] - lidar_range[0], 1.0)
    emb = np.stack([boxes[:, 0] / span, boxes[:, 1] / span, boxes[:, 2] / 10.0,
                    boxes[:, 3] / 4.0, boxes[:, 4] / 4.0, boxes[:, 5] / 8.0,
                    np.cos(boxes[:, 6]), np.sin(boxes[:, 6])], axis=1)
    n = np.linalg.norm(emb, axis=1, keepdims=True)
    return emb / np.maximum(n, 1e-9)
