"""Model registry (counterpart of airv2x_tpu/models/registry.py):
``airv2x_where2comm``, ``airv2x_v2xvit`` and the intermediate-fusion family
(``airv2x_attfusion`` / ``airv2x_intermediate``, ``airv2x_maxfusion``,
``airv2x_cobevt``, ``airv2x_v2vnet``, ``airv2x_when2com``), the camera-only
LSS baseline (``lift_splat_shoot_airv2x`` / ``lift_splat_shoot``), whose
``task`` (det or seg) the config names, and the OPV2V / DAIR-V2X flat
family: ``point_pillar``, ``point_pillar_intermediate`` /
``point_pillar_attfusion``, ``point_pillar_max`` / ``point_pillar_fcooper``,
``point_pillar_where2comm``, ``point_pillar_v2xvit``,
``point_pillar_cobevt``, ``point_pillar_v2vnet``, ``point_pillar_when2com``,
``point_pillar_baseline_multiscale``, ``point_pillar_disconet`` (DiscoNet's
student), ``point_pillar_how2comm``, ``point_pillar_coalign`` and
``point_pillar_scope`` (SCOPE temporal detection); the heterogeneous-collaboration models
``airv2x_heal``, ``airv2x_stamp`` and ``airv2x_sicp``; early fusion
(``point_pillar_early`` / ``airv2x_early`` and the DiscoNet teacher
``point_pillar_disconet_teacher``); BM2CP (``airv2x_bm2cp``, det or seg,
and the flat ``point_pillar_bm2cp``); and V2X-R: the flat SiCP
(``point_pillar_sicp``), the attention backbones
(``point_pillar_spatialcooper`` / ``point_pillar_adafusion``, ``PFA_net`` /
``pfanet`` / ``pfa_net``, ``point_pillar_attresnet``), the eight LiDAR +
4D-radar ``*_lrf`` twins, L4DR (``point_pillar_l4dr`` /
``point_pillar_L4DR``) and InterFusion (``point_pillar_interf`` /
``point_pillar_InterF``), RTNH (``RTNH_intermediate`` /
``rtnh_intermediate``) and the MDD denoiser
(``point_pillar_intermediate_lrf_MDD`` / ``point_pillar_mdd``). Every name
of the JAX package's registry is ported."""

from __future__ import annotations

import torch

from airv2x_tpu_torch.models.att_backbone_models import (
    PFAnet, PointPillarAttResNet, PointPillarSpatialCooper)
from airv2x_tpu_torch.models.bm2cp_model import Airv2xBM2CP
from airv2x_tpu_torch.models.coalign_model import PointPillarCoAlign
from airv2x_tpu_torch.models.early_fusion_model import (
    PointPillarDiscoNetTeacher, PointPillarEarly)
from airv2x_tpu_torch.models.heal_model import Airv2xHEAL
from airv2x_tpu_torch.models.how2comm_model import PointPillarHow2comm
from airv2x_tpu_torch.models.intermediate_models import (
    Airv2xAttFusion, Airv2xCoBEVT, Airv2xMaxFusion, Airv2xV2VNet,
    Airv2xWhen2com)
from airv2x_tpu_torch.models.lss_model import LiftSplatShoot
from airv2x_tpu_torch.models.point_pillar_models import (
    PointPillar, PointPillarBaselineMultiscale, PointPillarCoBEVT,
    PointPillarDiscoNet, PointPillarIntermediate, PointPillarMax, PointPillarSiCP,
    PointPillarV2VNet, PointPillarV2XViT, PointPillarWhen2com,
    PointPillarWhere2comm)
from airv2x_tpu_torch.models.point_pillar_bm2cp_model import PointPillarBM2CP
from airv2x_tpu_torch.models.radar_models import (
    LRF_MODELS, PointPillarInterF, PointPillarL4DR, PointPillarLRFMDD,
    RTNHIntermediate)
from airv2x_tpu_torch.models.scope_model import PointPillarScope
from airv2x_tpu_torch.models.stamp_model import Airv2xSiCP, Airv2xSTAMP
from airv2x_tpu_torch.models.v2xvit_model import Airv2xV2XViT
from airv2x_tpu_torch.models.where2comm_model import Airv2xWhere2comm
from airv2x_tpu_torch.utils.device import resolve_device

MODEL_REGISTRY = {"airv2x_where2comm": Airv2xWhere2comm,
                  "airv2x_v2xvit": Airv2xV2XViT,
                  "airv2x_attfusion": Airv2xAttFusion,
                  "airv2x_intermediate": Airv2xAttFusion,
                  "airv2x_maxfusion": Airv2xMaxFusion,
                  "airv2x_cobevt": Airv2xCoBEVT,
                  "airv2x_v2vnet": Airv2xV2VNet,
                  "airv2x_when2com": Airv2xWhen2com,
                  "lift_splat_shoot_airv2x": LiftSplatShoot,
                  "lift_splat_shoot": LiftSplatShoot,
                  "point_pillar": PointPillar,
                  "point_pillar_intermediate": PointPillarIntermediate,
                  "point_pillar_attfusion": PointPillarIntermediate,
                  "point_pillar_max": PointPillarMax,
                  "point_pillar_fcooper": PointPillarMax,
                  "point_pillar_where2comm": PointPillarWhere2comm,
                  "point_pillar_v2xvit": PointPillarV2XViT,
                  "point_pillar_cobevt": PointPillarCoBEVT,
                  "point_pillar_v2vnet": PointPillarV2VNet,
                  "point_pillar_when2com": PointPillarWhen2com,
                  "point_pillar_baseline_multiscale":
                      PointPillarBaselineMultiscale,
                  "point_pillar_disconet": PointPillarDiscoNet,
                  "point_pillar_how2comm": PointPillarHow2comm,
                  "point_pillar_coalign": PointPillarCoAlign,
                  "point_pillar_scope": PointPillarScope,
                  "airv2x_heal": Airv2xHEAL,
                  "airv2x_stamp": Airv2xSTAMP,
                  "airv2x_sicp": Airv2xSiCP,
                  "point_pillar_early": PointPillarEarly,
                  "airv2x_early": PointPillarEarly,
                  "point_pillar_disconet_teacher": PointPillarDiscoNetTeacher,
                  "airv2x_bm2cp": Airv2xBM2CP,
                  "point_pillar_bm2cp": PointPillarBM2CP,
                  "point_pillar_sicp": PointPillarSiCP,
                  "point_pillar_spatialcooper": PointPillarSpatialCooper,
                  "point_pillar_adafusion": PointPillarSpatialCooper,
                  "PFA_net": PFAnet, "pfanet": PFAnet, "pfa_net": PFAnet,
                  "point_pillar_attresnet": PointPillarAttResNet,
                  **LRF_MODELS,
                  "point_pillar_l4dr": PointPillarL4DR,
                  "point_pillar_L4DR": PointPillarL4DR,
                  "point_pillar_interf": PointPillarInterF,
                  "point_pillar_InterF": PointPillarInterF,
                  "RTNH_intermediate": RTNHIntermediate,
                  "rtnh_intermediate": RTNHIntermediate,
                  "point_pillar_intermediate_lrf_MDD": PointPillarLRFMDD,
                  "point_pillar_mdd": PointPillarLRFMDD}
DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16,
          "bfloat16": torch.bfloat16}


def compute_dtype(hypes: dict) -> torch.dtype:
    """The compute dtype ``hypes['model']['args']['dtype']`` names (default
    float32), as the JAX package's ``build_model`` reads it."""
    return DTYPES[str(hypes["model"]["args"].get("dtype", "float32"))]


def build_model(hypes: dict, *, device="cuda", train: bool = False):
    """Build the float32 model named by ``hypes['model']['core_method']`` on
    ``device``: frozen in eval mode, or with ``train`` trainable in train
    mode (its parameters stay f32, the optimizer's master weights; the train
    step computes in ``compute_dtype(hypes)``).

    The model args also carry the preprocess / postprocess sections. Raises
    when ``device`` is CUDA and no card is present.
    """
    dev = resolve_device(device)
    name = hypes["model"]["core_method"]
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; known: {sorted(MODEL_REGISTRY)}")
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    args.setdefault("postprocess", hypes.get("postprocess"))
    model = MODEL_REGISTRY[name](args).to(dev)
    if train:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)
