"""The port's tracking (``airv2x_tpu_torch/models/tracking.py``) against the
JAX package's on the CPU: ``TrackingHead`` through the weight bridge in f32,
and the host ``Tracker``'s ids on a seeded sequence with births, matches,
misses and tracks ageing out. (``geometry_embedding``, which the evaluation
CLI's ``--track`` feeds the tracker, is held to the JAX CLI's in
tests/test_torch_eval.py, where the JAX tool computes it.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.models import tracking as jax_tracking
from airv2x_tpu_torch.models import tracking
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.torch_port_helpers import one_torch_thread, random_variables  # noqa: F401

HEAD_TOL = 1e-5  # unit embeddings, f32, two dense layers


@pytest.mark.parametrize("c,d,n", [(16, 8, 5), (64, 128, 1)])
def test_tracking_head_matches_jax(c, d, n):
    rng = np.random.default_rng(c)
    feats = rng.standard_normal((12, 10, c)).astype(np.float32)
    boxes = rng.standard_normal((n, 7)).astype(np.float32)
    head = jax_tracking.TrackingHead(embed_dim=d)
    var = random_variables(head, jnp.asarray(feats), jnp.asarray(boxes), seed=c)
    want = np.asarray(head.apply(var, jnp.asarray(feats), jnp.asarray(boxes)))
    port = tracking.TrackingHead(c, d)
    load_flax_variables(port, var)
    with torch.no_grad():
        got = port(torch.from_numpy(feats), torch.from_numpy(boxes)).numpy()
    assert got.shape == (n, d)
    np.testing.assert_allclose(got, want, atol=HEAD_TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def _sequence(rng):
    """Frames of (boxes, unit embeddings): three objects, one of which is
    missed for two frames, one leaves for good (ages out at max_age 2), one
    is born late, and a frame with no detections."""
    base = rng.standard_normal((5, 8))
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    present = [(0, 1, 2), (2, 0, 1), (0, 2), (), (0, 3), (3, 0, 1, 4), (4, 1),
               (1, 4, 0), (0,), (0, 1, 2, 3, 4)]
    for ids in present:
        emb = base[list(ids)] + 0.05 * rng.standard_normal((len(ids), 8))
        emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
        yield rng.standard_normal((len(ids), 7)).astype(np.float32), emb


@pytest.mark.parametrize("threshold", [0.5, 0.9])
def test_tracker_ids_match_jax(threshold):
    ours = tracking.Tracker(sim_threshold=threshold, max_age=2)
    ref = jax_tracking.Tracker(sim_threshold=threshold, max_age=2)
    seen = set()
    for boxes, emb in _sequence(np.random.default_rng(4)):
        got = ours.update(boxes, emb)
        assert got == ref.update(boxes, emb)
        seen.update(got)
        assert [t["id"] for t in ours.tracks] == [t["id"] for t in ref.tracks]
        assert [t["age"] for t in ours.tracks] == [t["age"] for t in ref.tracks]
    assert len(seen) > 5  # births beyond the first frame's (ageing out)
