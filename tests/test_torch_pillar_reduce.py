"""K3's plain version in the PyTorch port against the JAX package's
``fused_pillar_reduce`` (interpret mode, as tests/test_fast_pillars.py runs
it) and its XLA twin ``reference_pillar_reduce``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.ops.pallas_pillars import (
    FEAT, LANES, NEG, fused_pillar_reduce, reference_pillar_reduce)
from airv2x_tpu_torch.ops import pillar_reduce as tpr
from tests.torch_port_helpers import assert_close

TOL = 1e-5  # the sums: f32 additions in another order


def _inputs(seed, m, n, cells, neg_share=0.2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cells + 1, (m, n)).astype(np.int32)  # incl. dump
    vals = rng.normal(size=(m, n, LANES)).astype(np.float32)
    vals[..., :FEAT] = np.where(rng.uniform(size=(m, n, 1)) > neg_share,
                                vals[..., :FEAT], NEG)
    return ids, vals


@pytest.mark.parametrize("m,n,cells", [(3, 137, 50), (2, 61, 7), (1, 8, 3)])
def test_plain_matches_pallas_and_reference(m, n, cells):
    ids, vals = _inputs(3, m, n, cells)
    ids[0, :5] = cells  # dump-row points at the head of a map
    want = np.asarray(fused_pillar_reduce(jnp.asarray(ids), jnp.asarray(vals),
                                          cells=cells, interpret=True))
    ref = np.asarray(reference_pillar_reduce(jnp.asarray(ids),
                                             jnp.asarray(vals), cells=cells))
    got = tpr.pillar_reduce(torch.from_numpy(ids), torch.from_numpy(vals),
                            cells)  # CPU: the plain version
    assert got.shape == (m, cells + 8, LANES) and got.dtype == torch.float32
    got = got.numpy()
    # the real rows against the kernel; every row, dump rows included,
    # against its XLA twin
    np.testing.assert_array_equal(got[:, :cells, :FEAT], want[:, :cells, :FEAT])
    assert_close(got[:, :cells], want[:, :cells], TOL, TOL, "vs pallas")
    np.testing.assert_array_equal(got[..., :FEAT], ref[..., :FEAT])
    assert_close(got, ref, TOL, TOL, "vs reference")
    # rows past the dump row keep their initial values
    assert (got[:, cells + 1:, :FEAT] == NEG).all()
    assert (got[:, cells + 1:, FEAT:] == 0).all()


def test_empty_cells_and_bf16_values():
    ids = np.full((1, 16), 4, np.int32)  # every point in the dump row
    vals = np.ones((1, 16, LANES), np.float32)
    got = tpr.pillar_reduce(torch.from_numpy(ids),
                            torch.from_numpy(vals).to(torch.bfloat16), 4)
    assert got.dtype == torch.float32
    assert (got[0, :4, :FEAT] == NEG).all() and (got[0, :4, FEAT:] == 0).all()
    assert (got[0, 4, :FEAT] == 1).all() and (got[0, 4, FEAT:] == 16).all()


def test_cell_limit_and_shapes():
    assert tpr.MAX_CELLS == 165_000
    assert tpr.pillar_reduce(torch.zeros((1, 8), dtype=torch.int32),
                             torch.zeros((1, 8, LANES)), 165_000).shape == (
        1, 165_008, LANES)
    ids = torch.zeros((1, 8), dtype=torch.int32)
    vals = torch.zeros((1, 8, LANES))
    with pytest.raises(ValueError, match="exceeds"):
        tpr.pillar_reduce(ids, vals, 165_001)
    with pytest.raises(ValueError, match="int32"):
        tpr.pillar_reduce(ids.long(), vals, 4)
    with pytest.raises(ValueError, match="vals"):
        tpr.pillar_reduce(ids, vals[..., :64], 4)
