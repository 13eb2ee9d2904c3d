"""DiscoNet in the PyTorch port against the JAX package on the CPU: the
student ``point_pillar_disconet`` (the flat family's tiny config,
tests/test_torch_point_pillar_family.py: 3 slots, the third absent in the
second sample, perturbed poses) and its distillation.

  * ``PixelWeightLayer`` through the bridge, eval, f32 1e-5;
  * the tiny student in both conv modes: psm / rm / ``student_feature``
    (NHWC) at 1e-4 x (1 + scale), its keep sets (NMS IoUs asserted more than
    1e-4 from the threshold), and an absent slot's points without effect;
  * ``point_pillar_disconet_loss``: parts and gradients with respect to the
    student's outputs against ``jax.grad``, with ``kd_weight`` and with a
    ``kd`` block;
  * one ``train_w_kd`` step (``DistilledStudent`` + ``make_train_step``)
    against the JAX tool's step body on the same variables, JAX in float64;
  * the KD CLI end to end: a teacher run dir from the port's train CLI, one
    step of the student.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from airv2x_tpu.loss import LOSS_REGISTRY as JAX_LOSSES
from airv2x_tpu.loss import build_loss as jax_build_loss
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.point_pillar_models import (
    PixelWeightLayer as JaxPixelWeightLayer)
from airv2x_tpu.parallel import train as jax_train
from airv2x_tpu_torch.config import load_yaml, save_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.loss import LOSS_REGISTRY, build_loss
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.point_pillar_models import PixelWeightLayer
from airv2x_tpu_torch.parallel.train import (
    TrainState, make_optimizer, make_train_step)
from airv2x_tpu_torch.tools import train, train_w_kd
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.test_torch_coalign import NMS_MARGIN, TOP_K, keep_sets
from tests.test_torch_point_pillar_family import batch  # noqa: F401
from tests.test_torch_point_pillar_family import tiny_hypes as flat_hypes
from tests.torch_port_helpers import one_torch_thread, random_variables  # noqa: F401
from tests.torch_train_helpers import (
    STEPS_PER_EPOCH, check_gradients, check_loss_parts, check_params_and_stats,
    f64, jax_model, twin)

TOL = 1e-4  # whole-model outputs, f32, x (1 + scale)
MODULE_TOL = 1e-5
GRAD_TOL = 1e-5  # of the largest gradient
KD_ARGS = {"cls_weight": 1.0, "reg": 2.0, "kd_weight": 1.0}
VAR_SEED = 5  # the KD step's student
TEACHER_SEED = 6
# the tiny student's forward: the first variables seed from 5 up whose NMS
# IoUs on the scene lie more than NMS_MARGIN from the threshold (seed 5's
# lie 4.4e-5 from it)
FORWARD_SEED = 25


def student_hypes():
    h = flat_hypes("point_pillar")
    h["model"]["core_method"] = "point_pillar_disconet"
    h["loss"] = {"core_method": "point_pillar_disconet_loss",
                 "args": copy.deepcopy(KD_ARGS)}
    return h


def teacher_hypes():
    h = flat_hypes("point_pillar")
    h["model"]["core_method"] = "point_pillar_disconet_teacher"
    return h


def _scene(b):
    return {k: v for k, v in b.items() if k != "labels"}


def test_pixel_weight_layer_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 8, 12, 64)).astype(np.float32)
    jm = JaxPixelWeightLayer()
    var = random_variables(jm, jnp.asarray(x), seed=1, train=False)
    want = np.asarray(jm.apply(var, jnp.asarray(x), train=False))
    m = PixelWeightLayer(64)
    load_flax_variables(m, var)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (3, 8, 12, 1) and (want > 0).sum() > 10
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=MODULE_TOL * (1 + np.abs(want).max()))


@pytest.fixture(scope="module")
def tiny_run(batch):  # noqa: F811
    hypes = student_hypes()
    jmodel = jax_build_model(hypes)
    jb = jax.tree.map(jnp.asarray, _scene(batch))
    var = random_variables(jmodel, jb, seed=FORWARD_SEED, train=False)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda v, b: jmodel.apply(v, b, train=False))(var, jb))
    return hypes, var, want


def _port(hypes, var, scene):
    model = build_model(hypes, device="cpu")
    load_flax_variables(model, var)
    with torch.no_grad():
        return model(batch_to_torch(scene, "cpu"))


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_tiny_disconet_matches_jax(batch, tiny_run, mode, monkeypatch):  # noqa: F811
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)
    hypes, var, want = tiny_run
    got = _port(hypes, var, _scene(batch))
    assert set(got) == set(want)
    for k in ("psm", "rm", "student_feature"):
        w = want[k]
        assert got[k].shape == w.shape and w.shape[:3] == (2, 32, 32)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=TOL * (1 + np.abs(w).max()), err_msg=k)
    assert float(got["comm_rate"]) == float(want["comm_rate"]) == 1.0
    pairs, margin = keep_sets(hypes, want, got)
    assert margin > NMS_MARGIN, margin
    for jkeep, tkeep in pairs:
        np.testing.assert_array_equal(tkeep, jkeep)
        assert 0 < jkeep.sum() < TOP_K


def test_absent_slot_does_not_enter(batch, tiny_run):  # noqa: F811
    hypes, var, _ = tiny_run
    moved = dict(_scene(batch), points=batch["points"].copy())
    moved["points"][1, 2, :, :2] *= 0.5
    a, b = _port(hypes, var, _scene(batch)), _port(hypes, var, moved)
    assert torch.equal(a["student_feature"], b["student_feature"])


@pytest.mark.parametrize("args", [KD_ARGS, {"cls_weight": 1.0, "reg": 2.0,
                                            "kd": {"weight": 3.0}}],
                         ids=["kd_weight", "kd_block"])
def test_disconet_loss_and_gradients_match_jax(args):
    rng = np.random.default_rng(4)
    f32 = np.float32
    out = {"psm": rng.normal(size=(2, 8, 8, 2)).astype(f32),
           "rm": rng.normal(size=(2, 8, 8, 14)).astype(f32),
           "student_feature": rng.normal(size=(2, 8, 8, 16)).astype(f32),
           "teacher_feature": rng.normal(size=(2, 8, 8, 16)).astype(f32)}
    tgt = {"pos_equal_one": (rng.uniform(size=(2, 8, 8, 2)) < 0.1).astype(f32),
           "targets": rng.normal(size=(2, 8, 8, 14)).astype(f32)}
    jfn = JAX_LOSSES["point_pillar_disconet_loss"](args)
    jt = {k: jnp.asarray(v) for k, v in tgt.items()}
    jo = {k: jnp.asarray(v) for k, v in out.items()}
    _, jparts = jfn(jo, jt)
    names = ("psm", "rm", "student_feature")
    jgrads = jax.grad(lambda *a: jfn(dict(jo, **dict(zip(names, a))), jt)[0],
                      argnums=(0, 1, 2))(*(jo[k] for k in names))
    fn = LOSS_REGISTRY["point_pillar_disconet_loss"](args)
    t_out = {k: torch.from_numpy(v).requires_grad_(k in names)
             for k, v in out.items()}
    total, parts = fn(t_out, {k: torch.from_numpy(v) for k, v in tgt.items()})
    total.backward()
    assert set(parts) == set(jparts) and "kd_loss" in parts
    for k in parts:
        assert float(parts[k].detach()) == pytest.approx(float(jparts[k]),
                                                         rel=1e-5), k
    for k, want in zip(names, jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(t_out[k].grad.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())
    # without the teacher's feature the loss is the binary one
    plain = fn({k: v.detach() for k, v in t_out.items() if k != "teacher_feature"},
               {k: torch.from_numpy(v) for k, v in tgt.items()})[1]
    assert "kd_loss" not in plain


def _jax_kd_step(sh, th, batch, s_var, t_var):
    """The JAX tool's step body (airv2x_tpu/tools/train_w_kd.py) in float64,
    one AdamW update of the config's schedule: (params, batch_stats, parts,
    grads), numpy."""
    with jax.enable_x64(True):
        cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(f64(a)), tree)  # noqa: E731
        student, teacher = jax_model(sh, jnp.float64), jax_model(th, jnp.float64)
        loss_fn = jax_build_loss(sh)
        tx, _ = jax_train.make_optimizer(sh, STEPS_PER_EPOCH)
        sv, tv, jb = cast(s_var), cast(t_var), cast(batch)

        def compute(params):
            s_out, updates = student.apply(
                {"params": params, "batch_stats": sv["batch_stats"]}, jb,
                train=True, rngs={"comm": jax.random.PRNGKey(7)},
                mutable=["batch_stats"])
            t_out = teacher.apply(tv, jb, train=False)
            s_out = dict(s_out)
            s_out.setdefault("student_feature", s_out["psm"])
            t_feat = t_out.get("teacher_feature", t_out.get("psm"))
            if t_feat.shape[-1] != s_out["student_feature"].shape[-1]:
                t_feat = t_out.get("teacher_psm", t_out.get("psm"))
                s_out["student_feature"] = s_out["psm"]
            s_out["teacher_feature"] = jax.lax.stop_gradient(t_feat)
            total, parts = loss_fn(s_out, jb["labels"])
            return total, (parts, updates["batch_stats"])

        (_, (parts, stats)), grads = jax.value_and_grad(compute, has_aux=True)(
            sv["params"])
        upd, _ = tx.update(grads, tx.init(sv["params"]), sv["params"])
        params = optax.apply_updates(sv["params"], upd)
        return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats),
                {k: float(v) for k, v in parts.items()},
                jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def kd_step_run(batch):  # noqa: F811
    sh, th = student_hypes(), teacher_hypes()
    scene = jax.tree.map(jnp.asarray, _scene(batch))
    s_var = random_variables(jax_build_model(sh), scene, seed=VAR_SEED,
                             train=False)
    t_var = random_variables(jax_build_model(th), scene, seed=TEACHER_SEED,
                             train=False)
    params, stats, jparts, grads = _jax_kd_step(sh, th, batch, s_var, t_var)
    student = build_model(sh, device="cpu", train=True)
    load_flax_variables(student, s_var)
    teacher = build_model(th, device="cpu")
    load_flax_variables(teacher, t_var)
    model = train_w_kd.DistilledStudent(student, teacher)
    opt, sched = make_optimizer(sh, student.parameters(), STEPS_PER_EPOCH)
    state = TrainState(model, opt)
    parts = make_train_step(build_loss(sh), sched)(
        state, batch_to_torch(batch, "cpu"))
    assert not teacher.training and all(
        p.grad is None for p in teacher.parameters())
    return dict(model=student, parts={k: float(v) for k, v in parts.items()},
                jparts=jparts, grads=twin(sh, grads, stats),
                after=twin(sh, params, stats))


def test_kd_step_loss_parts_match_jax(kd_step_run):
    check_loss_parts(kd_step_run["parts"], kd_step_run["jparts"])
    assert kd_step_run["parts"]["kd_loss"] > 0


def test_kd_step_gradients_match_jax(kd_step_run):
    check_gradients(kd_step_run["model"], kd_step_run["grads"])


def test_kd_step_params_and_bn_stats_match_jax(kd_step_run):
    assert check_params_and_stats(kd_step_run["model"], kd_step_run["after"],
                                  kd_step_run["grads"], min_clear=100) > 0


def test_distilled_student_falls_back_to_psm():
    """A teacher whose feature has other channels than the student's: both
    sides distil the cls logits, as the JAX tool's step."""
    class Teacher(torch.nn.Module):
        def forward(self, batch):
            return {"teacher_feature": torch.zeros(1, 4, 4, 7),
                    "teacher_psm": torch.full((1, 4, 4, 2), 3.0)}

    class Student(torch.nn.Module):
        def forward(self, batch):
            return {"psm": torch.ones(1, 4, 4, 2),
                    "student_feature": torch.ones(1, 4, 4, 5)}

    out = train_w_kd.DistilledStudent(Student(), Teacher()).train()({})
    assert torch.equal(out["student_feature"], out["psm"])
    assert float(out["teacher_feature"][0, 0, 0, 0]) == 3.0


def test_kd_cli_trains_from_a_teacher_run_dir(tmp_path):
    """The port's train CLI writes the teacher's run dir (one step), the KD
    CLI trains the student one step against it and saves epoch 1."""
    th, sh = teacher_hypes(), student_hypes()
    for h in (th, sh):
        h["preprocess"]["max_points"] = 512
        h["train_params"]["epoches"] = 1
    paths = {}
    for name, h in (("teacher", th), ("student", sh)):
        paths[name] = str(tmp_path / f"{name}.yaml")
        save_yaml(dict(h, name=f"tiny_{name}"), paths[name])
    teacher_dir = train.main(["--hypes_yaml", paths["teacher"], "--epochs", "1",
                              "--steps_per_epoch", "1", "--log_dir",
                              str(tmp_path / "logs"), "--device", "cpu"])
    res = train_w_kd.main(["--hypes_yaml", paths["student"], "--teacher_dir",
                           teacher_dir, "--steps_per_epoch", "1",
                           "--log_dir", str(tmp_path / "logs"), "--device", "cpu"])
    run_dir = res["run_dir"]
    assert os.path.isdir(run_dir) and run_dir != teacher_dir
    assert len(res["parts"]) == len(res["step_ms"]) == 1
    assert res["parts"][0]["kd_loss"] > 0
    assert load_yaml(os.path.join(run_dir, "config.yaml"))["model"][
        "core_method"] == "point_pillar_disconet"
    assert any(f.startswith("net_epoch1") for f in os.listdir(run_dir))
