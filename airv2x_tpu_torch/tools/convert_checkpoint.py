"""Convert a reference PyTorch checkpoint into a run dir of the port
(counterpart of airv2x_tpu/tools/convert_checkpoint.py).

    python -m airv2x_tpu_torch.tools.convert_checkpoint
        --checkpoint net_epoch50.pth --hypes_yaml config.yaml --output <run dir>
        [--epoch 1] [--seed 0] [--verbose] [--device cuda|cpu]

Reads the reference ``.pth`` (``module.`` prefixes stripped, a
``model_state_dict`` / ``state_dict`` wrapper unwrapped), maps it onto the
config's model through ``utils/torch_convert.py`` (a tensor whose shape does
not fit its target is skipped with a warning, a leaf no tensor fills keeps
the seeded initial value) and writes the run-dir layout every evaluation CLI
reads: ``config.yaml`` and ``net_epoch{N}`` (``utils/checkpoint.py``) with a
fresh optimizer state. Prints the assigned / skipped / leftover counts.
"""

from __future__ import annotations

import argparse
import os

from airv2x_tpu_torch.config import load_yaml, save_yaml
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.parallel.train import TrainState, make_optimizer
from airv2x_tpu_torch.utils.checkpoint import save_checkpoint
from airv2x_tpu_torch.utils.device import resolve_device
from airv2x_tpu_torch.utils.torch_convert import (
    load_reference_checkpoint, read_checkpoint)
from airv2x_tpu_torch.utils.weights import init_flax_like_


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="reference torch checkpoint -> port run dir")
    p.add_argument("--checkpoint", required=True, help=".pth state dict")
    p.add_argument("--hypes_yaml", required=True,
                   help="experiment yaml (the reference run dir's config.yaml works)")
    p.add_argument("--output", required=True, help="output run dir")
    p.add_argument("--epoch", type=int, default=1,
                   help="epoch index for the saved checkpoint")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def report(asg, verbose: bool) -> None:
    """Print the conversion's assigned / skipped / leftover counts (and,
    ``verbose``, the skipped targets and leftover tensors)."""
    print(f"converted {len(asg.assigned)} tensors; skipped {len(asg.skipped)}; "
          f"torch leftovers {len(asg.torch_leftovers)}")
    if verbose:
        for s in asg.skipped:
            print("  skipped:", s)
        for s in asg.torch_leftovers:
            print("  leftover:", s)


def main(argv=None):
    """Convert; returns the Assigner (``assigned``, ``skipped``,
    ``torch_leftovers``)."""
    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    hypes = load_yaml(opt.hypes_yaml)
    model = init_flax_like_(build_model(hypes, device=dev), opt.seed)
    asg = load_reference_checkpoint(model, read_checkpoint(opt.checkpoint), hypes)
    report(asg, opt.verbose)

    optimizer, _ = make_optimizer(hypes, model.parameters(), steps_per_epoch=1)
    os.makedirs(opt.output, exist_ok=True)
    save_yaml(hypes, os.path.join(opt.output, "config.yaml"))
    save_checkpoint(opt.output, opt.epoch, TrainState(model, optimizer))
    print(f"saved {os.path.join(opt.output, f'net_epoch{opt.epoch}')}")
    return asg


if __name__ == "__main__":
    main()
