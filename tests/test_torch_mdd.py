"""MDD of the port against the JAX package on the CPU:

  * ``fusion/mdd.py`` module by module through the weight bridge, f32,
    within 1e-4 x (1 + scale): the timestep embedding (even and odd
    widths), ``ResnetBlockDDIM`` with and without its 1x1 shortcut,
    ``AttnBlockDDIM``, the down / up samplers, a tiny ``DiffusionUNet``
    whose resolutions include 128 (the YAML's UNet never builds an
    attention block: ``resolution`` 128 with ``ch_mult`` (1, 1) never meets
    ``attn_resolutions: [16]``), the beta schedule bit for bit, and
    ``CondDiffDenoise`` on given noises; without them the port draws from
    a generator seeded ``NOISE_SEED`` in eval (JAX's ``PRNGKey(0)`` draws
    cannot be reproduced: ROADMAP §3) and anew on every train step;
  * the tiny ``PointPillarLRFMDD`` (test_torch_v2xr_models's flat config
    and radar batch, the YAML's UNet at ch 8 and T = 3) with the same
    ``mdd_noises`` in both packages: psm / rm, comm_rate, the keep sets;
  * ``point_pillar_loss_mdd``'s parts and its gradient with respect to
    ``pred_feature`` at epochs 1 and 30, and one train step at epoch 1
    (the clean-point mask ``de_points_mask`` in the batch, ``gt_feature``
    without a gradient) against JAX's float64 step;
  * the clean-point data: ``write_pcd(label=)`` / ``read_pcd(return_label=)``
    byte for byte against JAX's, and ``OPV2VDataset``'s MDD training
    samples (``de_points_mask``) on tests/test_torch_opv2v_data.py's split
    rewritten with ~10% of each cloud's points labelled weather noise.
"""

import copy
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airv2x_tpu.models.fusion.mdd as jmdd
from airv2x_tpu.data.opv2v_dataset import OPV2VDataset as JaxOPV2V
from airv2x_tpu.data.pcd import read_pcd as jax_read_pcd
from airv2x_tpu.data.pcd import write_pcd as jax_write_pcd
from airv2x_tpu.loss import build_loss as jax_build_loss
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu_torch.data.loader import RealDataLoader
from airv2x_tpu_torch.data.opv2v_dataset import OPV2VDataset
from airv2x_tpu_torch.data.pcd import read_pcd, write_pcd
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.loss import build_loss
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.fusion import mdd as tmdd
from airv2x_tpu_torch.parallel.train import (
    TrainState, make_optimizer, make_train_step)
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.test_torch_coalign import keep_sets
from tests.test_torch_data import assert_same_sample
from tests.test_torch_opv2v_data import hypes as opv2v_hypes
from tests.test_torch_opv2v_data import root  # noqa: F401
from tests.test_torch_v2xr_models import (
    NMS_MARGIN, batch, nms_decision_margin, v2xr_hypes)  # noqa: F401
from tests.torch_port_helpers import (
    assert_close, nchw_to_nhwc, nhwc_to_nchw, one_torch_thread,
    random_variables)  # noqa: F401
from tests.torch_train_helpers import (
    check_gradients, check_loss_parts, check_params_and_stats, jax_step,
    port_step, twin)

TOL = 1e-4
MDD_BLOCK = {"model": {"in_channels": 16, "out_ch": 16, "ch": 8,
                       "ch_mult": [1, 1], "num_res_blocks": 1,
                       "attn_resolutions": [16], "dropout": 0.0,
                       "resamp_with_conv": True},
             "diffusion": {"beta_schedule": "linear", "beta_start": 0.0005,
                           "beta_end": 0.02, "num_diffusion_timesteps": 3}}
T = 3
SEED = 5  # variables seed (its decode keeps boxes, NMS decisions clear)
NOISE_FRACTION = 0.1  # the share of each written cloud labelled weather noise


def mdd_hypes(name="point_pillar_intermediate_lrf_MDD"):
    h = v2xr_hypes("point_pillar_intermediate_lrf")
    h["model"]["core_method"] = name
    h["model"]["args"]["mdd_block"] = copy.deepcopy(MDD_BLOCK)
    h["loss"] = {"core_method": "point_pillar_loss_mdd",
                 "args": {"cls_weight": 1.0, "reg": 2.0}}
    return h


def _close(got, want, what=""):
    want = np.asarray(want)
    assert_close(got, want, atol=TOL * (1 + np.abs(want).max()), rtol=0, what=what)


def _x(rng, shape):
    return rng.normal(0, 1, shape).astype(np.float32)


# --- the modules ----------------------------------------------------------


@pytest.mark.parametrize("dim", [8, 9])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0.0, 1.0, 2.0, 17.0], np.float32)
    want = np.asarray(jmdd.get_timestep_embedding(jnp.asarray(t), dim))
    got = tmdd.get_timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert got.shape == want.shape == (4, dim)
    _close(got, want)


@pytest.mark.parametrize("kind", ["resnet", "resnet_nin", "attn", "down", "up"])
def test_unet_blocks_match_jax(kind):
    rng = np.random.default_rng(1)
    x = _x(rng, (2, 6, 10, 8))
    temb = _x(rng, (2, 32))
    if kind.startswith("resnet"):
        out = 16 if kind == "resnet_nin" else 8
        jm, tm, args = (jmdd.ResnetBlockDDIM(out), tmdd.ResnetBlockDDIM(8, out, 32),
                        (x, temb))
    elif kind == "attn":
        jm, tm, args = jmdd.AttnBlockDDIM(), tmdd.AttnBlockDDIM(8), (x,)
    elif kind == "down":
        jm, tm, args = jmdd._Downsample(True), tmdd._Downsample(8, True), (x,)
    else:
        jm, tm, args = jmdd._Upsample(True), tmdd._Upsample(8, True), (x,)
    var = random_variables(jm, *args, seed=2)
    want = np.asarray(jax.jit(jm.apply)(var, *map(jnp.asarray, args)))
    load_flax_variables(tm, var)
    targs = (nhwc_to_nchw(x),) + tuple(torch.from_numpy(a) for a in args[1:])
    with torch.no_grad():
        got = tm(*targs)
    assert (tm.nin_shortcut is not None) == (kind == "resnet_nin") if \
        kind.startswith("resnet") else True
    _close(nchw_to_nhwc(got), want)


@pytest.mark.parametrize("attn", [(16,), (128, 64)], ids=["yaml", "attention"])
def test_unet_matches_jax(attn):
    """The YAML's UNet at ch 8 (no attention block) and one whose running
    resolutions 128 / 64 each take an attention block."""
    cfg = dict(ch=8, out_ch=4, ch_mult=(1, 1), num_res_blocks=1,
               attn_resolutions=attn)
    rng = np.random.default_rng(3)
    x = _x(rng, (2, 8, 12, 8))
    t = np.array([2.0, 0.0], np.float32)
    jm = jmdd.DiffusionUNet(**cfg)
    var = random_variables(jm, x, t, seed=4)
    want = np.asarray(jax.jit(jm.apply)(var, jnp.asarray(x), jnp.asarray(t)))
    tm = tmdd.DiffusionUNet(in_channels=4, **cfg)
    load_flax_variables(tm, var)
    assert len(tm.attn_at) == (0 if attn == (16,) else 6)  # 1 + 1 down, 2 + 2 up
    with torch.no_grad():
        got = tm(nhwc_to_nchw(x), torch.from_numpy(t))
    _close(nchw_to_nhwc(got), want)


def test_beta_schedule_matches_jax():
    want, got = jmdd.mdd_beta_schedule(T), tmdd.mdd_beta_schedule(T)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cond_diff_denoise_matches_jax_and_draws_from_its_seed():
    rng = np.random.default_rng(5)
    lid, rad = _x(rng, (3, 8, 8, 4)), _x(rng, (3, 8, 8, 4))
    noises = _x(rng, (T,) + lid.shape)
    cfg = dict(MDD_BLOCK["model"], in_channels=4, out_ch=4)
    jm = jmdd.CondDiffDenoise(model_cfg=cfg, num_timesteps=T)
    var = random_variables(jm, lid, rad, noises=noises, seed=6)
    want = np.asarray(jax.jit(lambda v, a, b, n: jm.apply(v, a, b, noises=n))(
        var, jnp.asarray(lid), jnp.asarray(rad), jnp.asarray(noises)))
    tm = tmdd.CondDiffDenoise(cfg, T)
    load_flax_variables(tm, var)
    tl, tr = nhwc_to_nchw(lid), nhwc_to_nchw(rad)
    with torch.no_grad():
        got = tm(tl, tr, torch.from_numpy(noises))
        default = tm(tl, tr)
        g = torch.Generator().manual_seed(tmdd.NOISE_SEED)
        drawn = torch.randn((T,) + tuple(tl.shape), generator=g)
        again = tm(tl, tr, drawn.permute(0, 1, 3, 4, 2))
    _close(nchw_to_nhwc(got), want)
    torch.testing.assert_close(default, again, rtol=0, atol=0)
    assert (default - got).abs().max() > 1e-3  # the draws matter


# --- the tiny model -------------------------------------------------------


def _noises(batch):
    b, l = batch["points"].shape[:2]
    rng = np.random.default_rng(8)
    return rng.normal(0, 1, (T, b * l, 64, 64, 16)).astype(np.float32)


def _scene(batch):
    out = {k: v for k, v in batch.items() if k != "labels"}
    out["mdd_noises"] = _noises(batch)
    return out


@pytest.fixture(scope="module")
def jax_run(batch):  # noqa: F811
    h = mdd_hypes()
    model = jax_build_model(h)
    scene = jax.tree.map(jnp.asarray, _scene(batch))
    var = random_variables(model, scene, seed=SEED, train=False)
    out = jax.jit(lambda v, b: model.apply(v, b, train=False))(var, scene)
    return h, var, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("name", ["point_pillar_intermediate_lrf_MDD",
                                  "point_pillar_mdd"])
def test_mdd_forward_matches_jax(batch, jax_run, name):  # noqa: F811
    _, var, want = jax_run
    th = mdd_hypes(name)
    model = build_model(th, device="cpu")
    load_flax_variables(model, var)
    with torch.no_grad():
        got = model(batch_to_torch(_scene(batch), "cpu"))
    assert set(got) == set(want) == {"psm", "rm", "pred_feature", "comm_rate"}
    for k in ("psm", "rm", "pred_feature"):
        assert got[k].shape == want[k].shape
        _close(got[k].numpy(), want[k], k)
    # the denoised map is zero wherever the LiDAR map is
    assert (want["pred_feature"] == 0).mean() > 0.5
    assert float(got["comm_rate"]) == float(want["comm_rate"]) == 1.0
    assert nms_decision_margin(th, got) > NMS_MARGIN
    pairs, _ = keep_sets(th, want, got)
    for jkeep, tkeep in pairs:
        np.testing.assert_array_equal(tkeep, jkeep)
    assert sum(int(j.sum()) for j, _ in pairs) > 0


@pytest.mark.parametrize("epoch", [1, 30])
def test_mdd_loss_matches_jax(jax_run, epoch):
    """The detection parts and ``diff_loss`` (weight 1.5 (1 - tanh(epoch / 4
    - 5)): 2.9998 at epoch 1, 0.0199 at 30) from the same outputs, and the
    total's gradient with respect to ``pred_feature``."""
    h, _, out = jax_run
    rng = np.random.default_rng(epoch)
    out = dict(out, gt_feature=out["pred_feature"] + _x(
        rng, out["pred_feature"].shape) * 0.3)
    labels = {"pos_equal_one": (rng.uniform(size=out["psm"].shape) > 0.97
                                ).astype(np.float32),
              "targets": _x(rng, out["rm"].shape), "epoch": np.float32(epoch)}
    jloss = jax_build_loss(h)

    def jtotal(pred):
        return jloss(dict(jout, pred_feature=pred), jlabels)[0]

    jout, jlabels = (jax.tree.map(jnp.asarray, out),
                     jax.tree.map(jnp.asarray, labels))
    # eagerly: XLA's jitted f32 reduction of the squared error lies up to
    # 1.3e-5 (relative) from the float64 value, the eager one within 1e-6
    want = jloss(jout, jlabels)[1]
    want_grad = np.asarray(jax.jit(jax.grad(jtotal))(jout["pred_feature"]))
    tout = {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
    tout["pred_feature"].requires_grad_(True)
    total, got = build_loss(h)(tout, {k: torch.from_numpy(np.asarray(v))
                                      for k, v in labels.items()})
    total.backward()
    assert_close(tout["pred_feature"].grad.numpy(), want_grad,
                 atol=1e-5 * np.abs(want_grad).max(), rtol=0)
    assert set(got) == set(want) >= {"diff_loss", "total_loss"}
    # the weight's 1 - tanh(2.5) at epoch 30 keeps 1.3% of 1: the one-ulp
    # difference of XLA's and torch's f32 tanh moves it by up to 4.5e-6
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    weight = 1.5 * (1 - np.tanh(epoch / 4 - 5))
    d = ((out["gt_feature"] - out["pred_feature"]) ** 2).sum(-1).mean()
    assert float(got["diff_loss"]) == pytest.approx(d * weight, rel=1e-5)


@pytest.fixture(scope="module")
def step_run(batch, jax_run):  # noqa: F811
    """One train step at epoch 1 (the denoising term at its largest weight)
    on the labelled batch with its clean-point mask (each live point clean
    with probability 0.9) and noises."""
    jh, var, _ = jax_run
    b = _scene(batch)
    b["labels"] = dict(batch["labels"], epoch=np.float32(1))
    keep = np.random.default_rng(9).uniform(size=b["points_mask"].shape) < 0.9
    b["de_points_mask"] = b["points_mask"] & keep
    params, stats, jparts, grads = jax_step(jh, b, var, dtype=jnp.float64)
    th = mdd_hypes()
    model, parts = port_step(th, b, var)
    return dict(model=model, parts=parts, jparts=jparts,
                grads=twin(th, grads, stats), after=twin(th, params, stats))


def test_train_step_loss_parts_match_jax(step_run):
    assert "diff_loss" in step_run["jparts"]
    check_loss_parts(step_run["parts"], step_run["jparts"])


def test_train_step_gradients_match_jax(step_run):
    check_gradients(step_run["model"], step_run["grads"])


def test_train_step_params_and_bn_stats_match_jax(step_run):
    assert check_params_and_stats(step_run["model"], step_run["after"],
                                  step_run["grads"], min_clear=100) > 0


def test_train_steps_draw_new_noise_each_step(batch, jax_run, monkeypatch):  # noqa: F811
    """Without ``mdd_noises`` every train step draws the chain's noise anew
    from its (seed, step) generator, as JAX's step folds the step into its
    "diffusion" rng: two successive steps draw apart, a step replayed from
    the same seed and step draws the same, and eval draws ``NOISE_SEED``'s."""
    _, var, _ = jax_run
    drawn = []
    real = tmdd.default_noises

    def record(shape, device, generator=None):
        drawn.append(real(shape, device, generator))
        return drawn[-1]

    monkeypatch.setattr(tmdd, "default_noises", record)
    h = mdd_hypes()
    scene = {k: v for k, v in batch.items()}
    scene["labels"] = dict(batch["labels"], epoch=np.float32(1))
    tb = batch_to_torch(scene, "cpu")
    model = build_model(h, device="cpu", train=True)
    load_flax_variables(model, var)
    opt, sched = make_optimizer(h, model.parameters(), 10)
    step = make_train_step(build_loss(h), sched, seed=3)
    state = TrainState(model, opt)
    step(state, tb)
    step(state, tb)
    replay = TrainState(model, make_optimizer(h, model.parameters(), 10)[0])
    step(replay, tb)
    model.eval()
    with torch.no_grad():
        model(tb)
    first, second, again, default = drawn
    assert first.shape[0] == T and (first - second).abs().max() > 1
    torch.testing.assert_close(again, first, rtol=0, atol=0)
    torch.testing.assert_close(default, real(first.shape, "cpu"), rtol=0, atol=0)
    assert (default - first).abs().max() > 1


# --- the clean-point data -------------------------------------------------


def test_labelled_pcd_matches_jax(tmp_path):
    rng = np.random.default_rng(10)
    pts = _x(rng, (300, 4)) * 10
    pts[:, 3] = rng.uniform(0, 1, 300)
    label = np.where(rng.uniform(size=300) < NOISE_FRACTION, 1.0, 0.0)
    write_pcd(str(tmp_path / "port.pcd"), pts, label=label)
    jax_write_pcd(str(tmp_path / "jax.pcd"), pts, label=label)
    assert (tmp_path / "port.pcd").read_bytes() == (tmp_path / "jax.pcd").read_bytes()
    got_p, got_l = read_pcd(str(tmp_path / "jax.pcd"), return_label=True)
    want_p, want_l = jax_read_pcd(str(tmp_path / "jax.pcd"), return_label=True)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_l > 0, label > 0)
    np.testing.assert_array_equal(read_pcd(str(tmp_path / "jax.pcd")), want_p)
    np.testing.assert_allclose(got_p[:, 3], pts[:, 3], atol=0.5 / 255)


@pytest.fixture(scope="module")
def labelled_root(root, tmp_path_factory):  # noqa: F811
    """The OPV2V split with every LiDAR cloud rewritten with weather
    labels: NOISE_FRACTION of its points noise (label 1), the rest 0."""
    out = str(tmp_path_factory.mktemp("opv2v_mdd"))
    shutil.copytree(root, out, dirs_exist_ok=True)
    rng = np.random.default_rng(11)
    for dirpath, _, files in os.walk(out):
        for f in files:
            if f.endswith(".pcd") and "radar" not in f:
                path = os.path.join(dirpath, f)
                pts = read_pcd(path)
                write_pcd(path, pts, label=(rng.uniform(size=len(pts))
                                            < NOISE_FRACTION).astype(np.float32))
    return out


def test_mdd_training_samples_match_jax(labelled_root):
    """MDD's training samples carry ``de_points_mask`` (the points whose
    label is 0), equal to JAX's; its eval samples and other models' carry
    none; the loader stacks it."""
    h = opv2v_hypes()
    h["model"]["core_method"] = "point_pillar_mdd"
    jds = JaxOPV2V(h, labelled_root, train=True)
    tds = OPV2VDataset(h, labelled_root, train=True)
    assert len(tds) == len(jds) == 2
    for i in range(len(tds)):
        want, got = jds.__getitem__(i, epoch=0), tds.__getitem__(i, epoch=0)
        assert_same_sample(want, got, f"sample {i}")
        de, m = got[0]["de_points_mask"], got[0]["points_mask"]
        assert (de <= m).all() and 0.8 < de.sum() / m.sum() < 0.97
    assert "de_points_mask" not in OPV2VDataset(h, labelled_root, train=False)[0][0]
    h["model"]["core_method"] = "point_pillar"
    assert "de_points_mask" not in OPV2VDataset(h, labelled_root, train=True)[0][0]
    h["model"]["core_method"] = "point_pillar_mdd"
    loader = RealDataLoader(tds, h, 2, train=False, device="cpu")
    (b, _), = list(loader.batches(0, with_gt=True))
    assert tuple(b["de_points_mask"].shape) == tuple(b["points_mask"].shape)


# --- the CLIs -------------------------------------------------------------


@pytest.mark.parametrize("name", ["rtnh_intermediate",
                                  "point_pillar_intermediate_lrf_MDD"])
def test_cli_trains_and_serves(tmp_path, monkeypatch, name):
    """The train CLI on synthetic scenes (RTNH's without radar, MDD's with
    it: ``needs_radar``), one epoch of one step, every batch's labels
    carrying ``epoch`` 1; then the inference CLI on the run dir (its
    config given ``num_class: 1``, which the V2X-R YAMLs lack: ROADMAP
    §3)."""
    import yaml

    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.tools import inference, train
    from tests.test_torch_rtnh import rtnh_hypes

    h = rtnh_hypes(load_yaml) if name.startswith("rtnh") else mdd_hypes()
    h["preprocess"]["max_points"] = 512
    h["num_class"] = 1
    h["root_dir"] = str(tmp_path / "absent")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(jax.tree.map(
        lambda v: v.tolist() if hasattr(v, "tolist") else v, h)))
    seen = []
    real = train.build_loss

    def spy(hypes):
        fn = real(hypes)

        def loss(out, target, prefix=""):
            seen.append((float(target["epoch"]), "radar_points" in out_batch[-1],
                         "pred_feature" in out))
            return fn(out, target, prefix)
        return loss

    out_batch = []
    step = train.make_train_step

    def record(*a, **kw):
        inner = step(*a, **kw)

        def run(state, batch, **k):
            out_batch.append(batch)
            return inner(state, batch, **k)
        return run

    monkeypatch.setattr(train, "build_loss", spy)
    monkeypatch.setattr(train, "make_train_step", record)
    run_dir = train.main(["--hypes_yaml", str(cfg), "--device", "cpu",
                          "--log_dir", str(tmp_path / "logs"), "--epochs", "1",
                          "--steps_per_epoch", "1", "--batch_size", "2"])
    mdd = "MDD" in name
    assert seen[0] == (1.0, mdd, mdd)
    line = (tmp_path / "logs").glob("*/train_loss.txt").__next__().read_text()
    assert ("diff_loss" in line) == mdd and "nan" not in line
    res = inference.main(["--model_dir", run_dir, "--device", "cpu",
                          "--num_scenes", "1"])
    assert 0.0 <= res["ap_30"] <= 1.0 and res["comm_rate"] == 1.0
