"""The tiny ``airv2x_bm2cp`` seg model's train step against JAX's: the
checks and tolerances of tests/test_torch_bm2cp_train.py, in a file of its
own so that the two JAX compiles run on different workers."""

import pytest

from tests.test_torch_bm2cp_train import (  # noqa: F401 (collected here)
    bm2cp_step_run, test_bm2cp_train_step_gradients_match_jax,
    test_bm2cp_train_step_loss_parts_match_jax,
    test_bm2cp_train_step_params_and_bn_stats_match_jax)
from tests.torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def step_run():
    return bm2cp_step_run("airv2x_bm2cp", "seg")
