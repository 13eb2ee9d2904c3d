"""Repairs of the port's own faults, each held by a test:

  * CLI parity: every option that a JAX CLI (train, the four eval CLIs, the
    multi-stage recipe, the AP gate, KD training, the pose-graph precompute)
    accepts, the port's CLI accepts too,
    with two named exceptions; the port's ``--half`` parses and, as in
    JAX, changes nothing;
  * a mistyped ``AIRV2X_CONV_KERNEL`` raises and names the value.

The repeated-batch check's own tests are in tests/test_torch_train_models.py.
"""

import argparse
import importlib

import numpy as np
import pytest
import torch

from airv2x_tpu_torch.models.nn import CONV_KERNEL_MODES, ConvBNReLU
from airv2x_tpu_torch.tools import train as port_train

CLIS = ("train", "inference", "inference_airv2x", "inference_airv2x_seg",
        "inference_multi_scenario", "train_multi_stage", "chip_ap_gate",
        "train_w_kd", "pose_graph_pre_calc", "convert_checkpoint",
        "inference_pretrained", "inference_w_noise", "abl_object_dist",
        "debug_utils", "inference_tiny", "vis_data_sequence", "vis_feat", "demo")
# JAX options the port leaves out on purpose
EXCEPTIONS = {
    # rematerialisation of the backbone stages: torch checkpointing is queued
    # (ROADMAP §1 item 9)
    ("train", "--remat"),
    # a JAX matmul-precision flag; the port pins TF32 off instead
    # (tools/chip_ap_gate.py's set_tf32 call)
    ("chip_ap_gate", "--matmul_precision"),
}


class _Parser(Exception):
    pass


def options(module_name, monkeypatch) -> set:
    """The option strings of a CLI module's parser: ``parse_args`` is
    called with ``parse_args`` of argparse stopped before it reads argv."""
    mod = importlib.import_module(module_name)

    def stop(self, *a, **kw):
        raise _Parser(self)

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parser) as info:
            mod.parse_args()
    parser = info.value.args[0]
    return {s for act in parser._actions for s in act.option_strings
            if s.startswith("--") and s != "--help"}


@pytest.mark.parametrize("cli", CLIS)
def test_port_cli_accepts_every_jax_option(cli, monkeypatch):
    jax_opts = options(f"airv2x_tpu.tools.{cli}", monkeypatch)
    port_opts = options(f"airv2x_tpu_torch.tools.{cli}", monkeypatch)
    missing = {o for o in jax_opts - port_opts if (cli, o) not in EXCEPTIONS}
    assert not missing, f"{cli}: the port lacks {sorted(missing)}"
    # each exception is still a JAX option the port lacks
    for c, o in EXCEPTIONS:
        if c == cli:
            assert o in jax_opts and o not in port_opts, (c, o)


def test_half_parses_and_changes_nothing():
    base = ["--hypes_yaml", "cfg.yaml"]
    plain, half = port_train.parse_args(base), port_train.parse_args(base + ["--half"])
    assert half.half and not plain.half
    assert {k: v for k, v in vars(half).items() if k != "half"} == {
        k: v for k, v in vars(plain).items() if k != "half"}
    src = open(port_train.__file__).read()
    assert ".half" not in src.replace("--half", ""), "--half is read somewhere"


@pytest.mark.parametrize("value", ["palas", "cudnn", "PALLAS", ""])
def test_mistyped_conv_kernel_mode_raises(value, monkeypatch):
    block = ConvBNReLU(8, 8).eval()
    x = torch.zeros(1, 8, 6, 6)
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", value)
    with pytest.raises(ValueError, match=repr(value)):
        block(x)


@pytest.mark.parametrize("value", CONV_KERNEL_MODES)
def test_every_conv_kernel_mode_runs(value, monkeypatch):
    block = ConvBNReLU(8, 8).eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 8, 6, 6)).astype(np.float32))
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", "auto")
    with torch.no_grad():
        want = block(x)
        monkeypatch.setenv("AIRV2X_CONV_KERNEL", value)
        got = block(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
