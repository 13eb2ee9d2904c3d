"""The PyTorch port's BEV trunk against the JAX package, module by module:
conv blocks, the backbone, the heads, and the Where2comm fusion parts."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.models.bev_backbone import BaseBEVBackbone as JaxBackbone
from airv2x_tpu.models.fusion import where2comm as jw2c
from airv2x_tpu.models.fusion.common import ego_agent_attention as jax_ego_attention
from airv2x_tpu.models.heads import DetectionHeads as JaxHeads
from airv2x_tpu.models.nn import ConvBNReLU as JaxConvBNReLU
from airv2x_tpu.models.nn import DeconvBNReLU as JaxDeconvBNReLU
from airv2x_tpu.models.nn import DownsampleConv as JaxDownsampleConv
from airv2x_tpu_torch.models.bev_backbone import BaseBEVBackbone
from airv2x_tpu_torch.models.fusion.common import ego_agent_attention
from airv2x_tpu_torch.models.fusion.where2comm import (
    Communication, Where2commFusion, gaussian_smooth)
from airv2x_tpu_torch.models.heads import DetectionHeads
from airv2x_tpu_torch.models.nn import ConvBNReLU, DeconvBNReLU, DownsampleConv
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.torch_port_helpers import (
    assert_close, nchw_to_nhwc, nhwc_to_nchw, random_variables)

TOL = 1e-5  # f32 module tests
THRESH = 0.01  # the eval communication threshold


def _x(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _check_module(jmod, tmod, x, train_arg=True, seed=0):
    kw = {"train": False} if train_arg else {}
    var = random_variables(jmod, jnp.asarray(x), seed=seed, **kw)
    want = np.asarray(jmod.apply(var, jnp.asarray(x), **kw))
    load_flax_variables(tmod, var)
    with torch.no_grad():
        got = nchw_to_nhwc(tmod.eval()(nhwc_to_nchw(x)))
    assert_close(got, want, TOL, TOL, type(tmod).__name__)
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_bn_relu(stride):
    x = _x(0, (2, 11, 13, 6))
    _check_module(JaxConvBNReLU(8, stride=stride), ConvBNReLU(6, 8, stride), x)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_deconv_bn_relu(stride):
    x = _x(1, (2, 5, 7, 6))
    _check_module(JaxDeconvBNReLU(8, stride), DeconvBNReLU(6, 8, stride), x)


def test_downsample_conv():
    x = _x(2, (2, 9, 10, 6))
    kw = dict(dims=[12, 10], kernels=[1, 3], strides=[1, 2], paddings=[0, 1])
    _check_module(JaxDownsampleConv(**kw), DownsampleConv(6, **kw), x)


def test_detection_heads():
    x = _x(3, (2, 6, 7, 10))
    jmod = JaxHeads(anchor_number=2, num_class=7)
    var = random_variables(jmod, jnp.asarray(x))
    want = jmod.apply(var, jnp.asarray(x))
    tmod = DetectionHeads(10, anchor_number=2, num_class=7)
    load_flax_variables(tmod, var)
    with torch.no_grad():
        got = tmod(nhwc_to_nchw(x))
    assert set(got) == set(want) == {"psm", "rm", "obj"}
    for k in got:
        assert_close(nchw_to_nhwc(got[k]), np.asarray(want[k]), TOL, TOL, k)


BB = dict(layer_nums=[1, 2], layer_strides=[2, 2], num_filters=[8, 16],
          upsample_strides=[1, 2], num_upsample_filters=[8, 8])


def test_backbone_out_and_multiscale():
    x = _x(4, (2, 20, 24, 6))
    jmod = JaxBackbone(**BB)
    var = random_variables(jmod, jnp.asarray(x), seed=5, train=False)
    want_out, want_ms = jmod.apply(var, jnp.asarray(x), train=False)
    tmod = BaseBEVBackbone(6, **BB).eval()
    load_flax_variables(tmod, var)
    with torch.no_grad():
        got_out, got_ms = tmod(nhwc_to_nchw(x))
    assert_close(nchw_to_nhwc(got_out), np.asarray(want_out), TOL, TOL, "out")
    assert set(got_ms) == set(want_ms) == {"spatial_features_2x",
                                            "spatial_features_4x"}
    for k in got_ms:
        assert_close(nchw_to_nhwc(got_ms[k]), np.asarray(want_ms[k]), TOL, TOL, k)


def test_gaussian_smooth():
    conf = np.random.default_rng(6).uniform(0, 1, (2, 3, 9, 11)).astype(np.float32)
    want = np.asarray(jw2c.gaussian_smooth(jnp.asarray(conf), 5, 1.0))
    got = gaussian_smooth(torch.from_numpy(conf), 5, 1.0).numpy()
    assert_close(got, want, TOL, TOL, "smooth")


def _bimodal_psm(seed, shape):
    """NHWC logits: background at sigmoid ~1e-4, sparse blobs at ~0.95, so
    every smoothed confidence lies far from the threshold."""
    rng = np.random.default_rng(seed)
    psm = rng.uniform(-9.5, -8.5, shape).astype(np.float32)
    blobs = rng.uniform(size=shape[:-1]) > 0.94
    psm[blobs] = rng.uniform(2.5, 3.5, (int(blobs.sum()), shape[-1]))
    return psm


def _assert_conf_gap(psm_nhwc):
    conf = gaussian_smooth(torch.sigmoid(torch.from_numpy(psm_nhwc).double())
                           .amax(-1), 5, 1.0)
    gap = float((conf - THRESH).abs().min())
    assert gap > 1e-4, f"a smoothed confidence lies {gap:.2e} from {THRESH}"
    return conf


def test_communication_eval():
    psm = _bimodal_psm(7, (2, 3, 12, 14, 4))
    conf = _assert_conf_gap(psm)
    assert 0 < float((conf > THRESH).double().mean()) < 1  # the mask is mixed
    am = np.array([[True, True, False], [True, False, True]])
    (want_mask, want_rate) = jw2c.Communication().apply(
        {}, jnp.asarray(psm), jnp.asarray(am), train=False)
    mask, rate = Communication().eval()(
        torch.from_numpy(psm).permute(0, 1, 4, 2, 3), torch.from_numpy(am))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert float(rate) == pytest.approx(float(want_rate), abs=1e-7)
    assert float(rate) < 1.0


def test_ego_agent_attention():
    x = _x(8, (2, 4, 5, 6, 8))
    am = np.array([[True, True, False, True], [True, False, False, False]])
    want = np.asarray(jax_ego_attention(jnp.asarray(x), jnp.asarray(am)))
    got = ego_agent_attention(torch.from_numpy(x).permute(0, 1, 4, 2, 3),
                              torch.from_numpy(am))
    assert_close(got.permute(0, 2, 3, 1).numpy(), want, TOL, TOL, "attention")


class _JaxFusionWrap(fnn.Module):
    """The shared backbone and the fusion under one parent, as in the model."""

    def setup(self):
        self.backbone = JaxBackbone(**BB)
        self.fusion = jw2c.Where2commFusion(multi_scale=True)

    def __call__(self, x, psm, am):
        return self.fusion(x, psm, am, self.backbone, False)


class _FusionWrap(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = BaseBEVBackbone(6, **BB)
        self.fusion = Where2commFusion(multi_scale=True)

    def forward(self, x, psm, am):
        return self.fusion(x, psm, am, self.backbone)


# stage 0 runs at 10 x 12: the first psm shape skips the resize, the others
# take the bilinear resize up from an odd shape and down to it
@pytest.mark.parametrize("psm_hw", [(10, 12), (7, 9), (13, 17)])
def test_where2comm_fusion_multiscale(psm_hw):
    x = _x(9, (2, 3, 20, 24, 6))
    psm = _bimodal_psm(10, (2, 3) + psm_hw + (4,))
    _assert_conf_gap(psm)
    am = np.array([[True, True, True], [True, False, True]])
    jmod = _JaxFusionWrap()
    args = (jnp.asarray(x), jnp.asarray(psm), jnp.asarray(am))
    var = random_variables(jmod, *args, seed=11)
    want, want_rate = jax.jit(jmod.apply)(var, *args)
    tmod = _FusionWrap().eval()
    load_flax_variables(tmod, var)
    with torch.no_grad():
        got, rate = tmod(torch.from_numpy(x),
                         torch.from_numpy(psm).permute(0, 1, 4, 2, 3),
                         torch.from_numpy(am))
    assert got.shape == (2, 16, 10, 12)
    assert_close(nchw_to_nhwc(got), np.asarray(want), TOL, TOL, "fused")
    assert float(rate) == pytest.approx(float(want_rate), abs=1e-7)
