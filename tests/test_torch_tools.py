"""The port's tool CLIs against the JAX package's, on the CPU.

One tiny Where2comm sits in a JAX and a port run dir as epoch 1
(tests/test_torch_eval.py's ``_run_dirs``: one set of flax variables, a
near-constant single-agent confidence so that the comm mask is decided far
from its threshold). ``inference_w_noise`` and ``abl_object_dist`` run in
both packages on the same seeded scenes and must write the same AP tables;
``inference_pretrained`` reads one reference-named ``.pth`` of that model
in both (and, through the port's ``convert_checkpoint``, a port
``net_epoch7``) and must write JAX's AP line. Every AP comparison asserts that no IoU the port
computed lies within IOU_MARGIN of a threshold (the two packages' IoUs
agree to ~1e-5). The rest run the port alone and check what they write:
``debug_utils``'s own round-trip assertion, ``inference_tiny``,
``vis_data_sequence``, ``vis_feat`` and ``demo --epochs 1 --steps 2``'s
files, and ``config_generate``'s YAML against JAX's.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.tools import abl_object_dist as jax_abl
from airv2x_tpu.tools import config_generate as jax_config_generate
from airv2x_tpu.tools import inference_pretrained as jax_pretrained
from airv2x_tpu.tools import inference_w_noise as jax_noise
from airv2x_tpu.tools import vis_feat as jax_vis_feat
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.eval import ap
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.ops.quad_iou import quad_iou_plain
from airv2x_tpu_torch.tools import (
    abl_object_dist, config_generate, convert_checkpoint, debug_utils, demo,
    inference_multi_scenario, inference_pretrained, inference_tiny,
    inference_w_noise, vis_data_sequence, vis_feat)
from airv2x_tpu_torch.utils.checkpoint import load_model_weights
from airv2x_tpu_torch.utils.torch_convert import reference_state_dict
from airv2x_tpu_torch.utils.weights import flax_variables
from tests.test_torch_eval import _run_dirs
from tests.torch_port_helpers import TINY, one_torch_thread  # noqa: F401

IOU_MARGIN = 1e-4


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return _run_dirs(str(tmp_path_factory.mktemp("tool_runs")), seg=False)


@pytest.fixture
def ap_ious(monkeypatch):
    """Every det x gt IoU matrix the port's AP computes."""
    seen = []

    def recording(c1, c2, **kw):
        out = quad_iou_plain(c1, c2)
        seen.append(out.numpy().copy())
        return out

    monkeypatch.setattr(ap, "quad_iou", recording)
    return seen


def _assert_margin(ious):
    assert ious, "the AP computed no IoU"
    for iou in ious:
        for t in ap.IOU_THRESHOLDS:
            assert np.abs(iou - t).min() > IOU_MARGIN, f"an IoU near {t}"


def _jax(main, argv, monkeypatch):
    monkeypatch.setattr("sys.argv", ["prog"] + argv)
    main()


def test_inference_w_noise_matches_jax(dirs, ap_ious, monkeypatch):
    jax_dir, port_dir = dirs
    argv = ["--num_scenes", "1", "--noise_levels", "0", "0.4", "--seed", "3"]
    _jax(jax_noise.main, ["--model_dir", jax_dir] + argv, monkeypatch)
    got = inference_w_noise.main(["--model_dir", port_dir, "--device", "cpu"] + argv)
    _assert_margin(ap_ious)
    tables = [json.load(open(os.path.join(d, "noise_sweep.json"))) for d in dirs]
    assert tables[0] == tables[1] and set(tables[1]) == {"0.0", "0.4"}
    assert got[0.4] == tables[1]["0.4"]
    assert any(v > 0 for v in tables[0]["0.0"].values()), "no TP: a weak test"
    assert tables[0]["0.0"] != tables[0]["0.4"], "the noise moved nothing"


def test_abl_object_dist_matches_jax(dirs, ap_ious, monkeypatch):
    jax_dir, port_dir = dirs
    argv = ["--num_scenes", "2", "--range", "12.8,12.8", "--buckets", "0,8,1e9",
            "--seed", "0"]
    _jax(jax_abl.main, ["--model_dir", jax_dir] + argv, monkeypatch)
    got = abl_object_dist.main(["--model_dir", port_dir, "--device", "cpu"] + argv)
    _assert_margin(ap_ious)
    tables = [load_yaml(os.path.join(d, "abl_object_dist.yaml")) for d in dirs]
    assert tables[0] == tables[1]
    assert set(tables[1]) == {"overall", "0-8m", "8m+"}
    assert got["overall"] == tables[1]["overall"]
    assert any(v > 0 for v in tables[0]["overall"].values()), "no TP: a weak test"


@pytest.fixture(scope="module")
def pth(dirs, tmp_path_factory):
    """A reference-named .pth (``module.``-prefixed, wrapped in
    ``model_state_dict``) of the run dirs' tiny model: the tensors the
    converter turns into its weights."""
    hypes = load_yaml(TINY)
    model = load_model_weights(dirs[1], 1, build_model(hypes, device="cpu"))
    sd = reference_state_dict(hypes, flax_variables(model), values=True)
    path = str(tmp_path_factory.mktemp("pth") / "net_epoch7.pth")
    torch.save({"model_state_dict": {"module." + k: torch.from_numpy(v)
                                     for k, v in sd.items()}}, path)
    return path


def test_inference_pretrained_matches_jax(pth, tmp_path, ap_ious, monkeypatch):
    argv = ["--hypes_yaml", TINY, "--num_scenes", "1", "--seed", "3"]
    out = {k: str(tmp_path / k) for k in ("jax", "pth", "run", "epoch")}
    _jax(jax_pretrained.main, ["--model_path", pth, "--out_dir", out["jax"]] + argv,
         monkeypatch)
    got = inference_pretrained.main(["--model_path", pth, "--out_dir", out["pth"],
                                     "--device", "cpu", "--save_npy",
                                     "--save_vis_n", "1"] + argv)
    _assert_margin(ap_ious)
    asg = convert_checkpoint.main(["--checkpoint", pth, "--hypes_yaml", TINY,
                                   "--output", out["run"], "--epoch", "7",
                                   "--device", "cpu"])
    assert not asg.skipped and not asg.torch_leftovers
    inference_pretrained.main(["--model_path", os.path.join(out["run"], "net_epoch7"),
                               "--out_dir", out["epoch"], "--device", "cpu"] + argv)
    lines = [open(os.path.join(out[k], "results.txt")).read()
             for k in ("jax", "pth", "epoch")]
    assert lines[0] == lines[1] == lines[2]
    assert got["ap_30"] > 0, "no TP: a weak test"
    assert os.path.getsize(os.path.join(out["pth"], "vis_0000.png")) > 0
    npy = sorted(os.listdir(os.path.join(out["pth"], "npy")))
    assert npy == [f"0000_{k}.npy" for k in ("gt", "pcd", "pred", "pred_score")]
    # the converted run dir is one the evaluation CLIs read
    table = inference_multi_scenario.main(["--model_dir", out["run"], "--device",
                                           "cpu", "--num_scenes", "2"])
    assert 0.0 <= table["COMBINED"]["ap_30"] <= 1.0


def test_debug_utils_round_trip(tmp_path):
    out = str(tmp_path / "overlay.png")
    got = debug_utils.main(["--hypes_yaml", TINY, "--num_scenes", "2", "--out", out,
                            "--device", "cpu"])
    assert got["ap_70"] >= 0.99 and got["worst_corner_m"] < 1e-3
    assert os.path.getsize(out) > 0


def test_inference_tiny_writes_renders(dirs):
    port_dir = dirs[1]
    got = inference_tiny.main(["--model_dir", port_dir, "--num_scenes", "2",
                               "--device", "cpu"])
    vis = sorted(os.listdir(os.path.join(port_dir, "vis")))
    assert {"bev_00000.png", "bev_00001.png", "3d_00000.png", "3d_00001.png"} <= set(vis)
    last = open(os.path.join(port_dir, "results.txt")).read().splitlines()[-1]
    assert last == (f"tiny: AP@0.3: {got['ap_30']:.4f} AP@0.5: {got['ap_50']:.4f} "
                    f"AP@0.7: {got['ap_70']:.4f}")


def test_vis_tools_write_their_files(tmp_path):
    seq = vis_data_sequence.main(["--hypes_yaml", TINY, "--output_dir",
                                  str(tmp_path / "seq"), "--frames", "2"])
    assert [os.path.basename(p) for p in seq] == ["frame_0000.png", "frame_0001.png"]
    feat = vis_feat.main(["--hypes_yaml", TINY, "--output_dir", str(tmp_path / "feat"),
                          "--filter", "heads", "--device", "cpu"])
    names = [os.path.basename(p) for p in feat]
    assert "heads_cls_head.png" in names and "heads_reg_head.png" in names
    assert all(os.path.getsize(p) > 0 for p in seq + feat)
    # the heatmap of a map is JAX's (its map channels-last, the port's first)
    rng = np.random.default_rng(6)
    for scale in (1e-3, 1.0, 40.0):
        x = (rng.standard_normal((1, 48, 48, 16)) * scale).astype(np.float32)
        jax_vis_feat._heatmap(str(tmp_path / "jax.png"), x)
        np.testing.assert_array_equal(
            vis_feat.heatmap(x.transpose(0, 3, 1, 2)),
            np.asarray(Image.open(tmp_path / "jax.png")))


def test_demo_smoke_run(tmp_path):
    got = demo.main(["--epochs", "1", "--steps", "2", "--log_dir", str(tmp_path),
                     "--num_scenes", "2", "--device", "cpu"])
    run = got["run_dir"]
    for name in ("config.yaml", "net_epoch1", "results.txt", "train_loss.txt",
                 "demo_summary.json"):
        assert os.path.exists(os.path.join(run, name)), name
    assert json.load(open(os.path.join(run, "demo_summary.json")))["gate"] == got["gate"]


def test_config_generate_writes_jax_yaml(tmp_path, monkeypatch):
    want, out = str(tmp_path / "jax.yaml"), str(tmp_path / "port.yaml")
    _jax(jax_config_generate.main, ["--hypes_yaml", TINY, "--output", want],
         monkeypatch)
    config_generate.main(["--hypes_yaml", TINY, "--output", out])
    assert open(out).read() == open(want).read()
    assert jax_load_yaml(out)["model"]["core_method"] == "airv2x_where2comm"
