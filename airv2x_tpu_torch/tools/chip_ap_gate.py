"""Card-vs-CPU AP gate (counterpart of airv2x_tpu/tools/chip_ap_gate.py):
the same evaluation must give the same AP table on the card and on the CPU.

    python -m airv2x_tpu_torch.tools.chip_ap_gate [--epochs 20] [--steps 20]
        [--num_scenes 16] [--tol 5e-3] [--archive <path.json>]
        [--model_dir <run dir>]

Trains the tiny recipe (``hypes_yaml/test/tiny_where2comm.yaml``, its lr
steps moved past the loss plateau as the JAX gate moves them) through the
port's train CLI on synthetic scenes on the card, then runs
``inference_multi_scenario`` on the identical seeded eval scenes on the card
and, in the same process, with ``--device cpu``: both with the f32 model,
TF32 off and cuDNN pinned (no autotuner, deterministic algorithms). It
asserts that the two COMBINED AP tables agree within ``--tol`` per
threshold (``identical`` in the artifact says whether every AP of the two,
per scenario and COMBINED, is equal), and prints beside them, unasserted,
the card's table with the model cast to bf16 in process (the serving
precision). Prints the artifact and writes it to ``--archive``; exits
non-zero on FAIL.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import json
import os
import sys

import torch

from airv2x_tpu_torch.config import load_yaml, save_yaml
from airv2x_tpu_torch.tools import inference_multi_scenario, train
from airv2x_tpu_torch.tools.inference import load_run
from airv2x_tpu_torch.utils.weights import cast_weights_

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = os.path.join(REPO, "hypes_yaml/test/tiny_where2comm.yaml")
AP_KEYS = ("ap_30", "ap_50", "ap_70")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="card-vs-CPU AP parity gate")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--steps", type=int, default=20, help="steps per epoch")
    p.add_argument("--log_dir", type=str, default="logs")
    p.add_argument("--num_scenes", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_seed", type=int, default=123)
    p.add_argument("--tol", type=float, default=5e-3,
                   help="max |AP_card - AP_cpu| per threshold")
    p.add_argument("--archive", type=str, default="",
                   help="path to write the gate artifact JSON")
    p.add_argument("--model_dir", type=str, default="",
                   help="skip training, gate an existing run dir")
    return p.parse_args(argv)


def parse_results(run_dir: str) -> dict:
    """{name: AP dict} of the ``name: {...}`` lines of ``results.txt`` (a
    later line of one name wins)."""
    table = {}
    with open(os.path.join(run_dir, "results.txt")) as f:
        for line in f:
            if ":" in line:
                name, payload = line.split(":", 1)
                try:
                    table[name.strip()] = ast.literal_eval(payload.strip())
                except (ValueError, SyntaxError):
                    pass
    if "COMBINED" not in table:
        raise RuntimeError(f"no COMBINED line in {run_dir}/results.txt")
    return table


def infer(run_dir: str, num_scenes: int, eval_seed: int, device: str) -> dict:
    """``inference_multi_scenario`` on ``device`` (synthetic scenes: the
    tiny config names no test dir); its table as it appended it to
    ``results.txt``."""
    inference_multi_scenario.main([
        "--model_dir", run_dir, "--num_scenes", str(num_scenes),
        "--seed", str(eval_seed), "--device", device])
    return parse_results(run_dir)


def train_tiny(opt) -> str:
    """The tiny recipe through the train CLI on the card; its run dir."""
    hypes = load_yaml(TINY)
    hypes["train_params"]["epoches"] = opt.epochs
    hypes["train_params"]["save_freq"] = max(opt.epochs // 4, 1)
    hypes["train_params"]["eval_freq"] = max(opt.epochs // 4, 1)
    # the loss plateaus until the lr decays; the tiny config's 10 / 25 / 40
    # steps freeze the lr long before convergence, so move them past it
    hypes["lr_scheduler"]["step_size"] = [
        max(int(opt.epochs * 70 / 130), 1), max(int(opt.epochs * 110 / 130), 2)]
    os.makedirs(opt.log_dir, exist_ok=True)
    cfg_path = os.path.join(opt.log_dir, "chip_ap_gate.yaml")
    save_yaml(hypes, cfg_path)
    return train.main(["--hypes_yaml", cfg_path, "--log_dir", opt.log_dir,
                       "--steps_per_epoch", str(opt.steps),
                       "--seed", str(opt.seed), "--synthetic",
                       "--device", "cuda"])


@contextlib.contextmanager
def pinned_precision():
    """f32 computed in f32 inside the block: TF32 off, cuDNN without its
    autotuner and with deterministic algorithms."""
    cudnn = torch.backends.cudnn
    flags = (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
             cudnn.benchmark, cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = cudnn.allow_tf32 = False
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
         cudnn.benchmark, cudnn.deterministic) = flags


def ap_rows(table: dict) -> dict:
    """{scenario or "COMBINED": (AP@0.3, AP@0.5, AP@0.7)} of a table."""
    return {name: tuple(row[k] for k in AP_KEYS) for name, row in table.items()}


def infer_bf16(run_dir: str, num_scenes: int, eval_seed: int) -> dict:
    """The card's table with the run's best weights cast to bf16 in
    process (``load_run``'s serving cast)."""
    hypes, model, _ = load_run(run_dir, "cuda")
    cast_weights_(model, torch.bfloat16)
    table, _, _ = inference_multi_scenario.evaluate(hypes, model, "cuda", "",
                                                    num_scenes, eval_seed)
    return table


def main(argv=None) -> dict:
    opt = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("chip_ap_gate compares the card with the CPU: no "
                           "CUDA device is available")
    run_dir = opt.model_dir or train_tiny(opt)
    print(f"gate run dir: {run_dir}")
    with pinned_precision():
        card = infer(run_dir, opt.num_scenes, opt.eval_seed, "cuda")
        cpu = infer(run_dir, opt.num_scenes, opt.eval_seed, "cpu")
        bf16 = infer_bf16(run_dir, opt.num_scenes, opt.eval_seed)

    diffs = {k: abs(card["COMBINED"][k] - cpu["COMBINED"][k]) for k in AP_KEYS}
    ok = max(diffs.values()) <= opt.tol
    artifact = {
        "device": torch.cuda.get_device_name(0),
        "run_dir": run_dir,
        "tol": opt.tol,
        "ap_card": {k: card["COMBINED"][k] for k in AP_KEYS},
        "ap_cpu": {k: cpu["COMBINED"][k] for k in AP_KEYS},
        "abs_diff": diffs,
        "identical": ap_rows(card) == ap_rows(cpu),
        "ap_card_bf16": {k: bf16["COMBINED"][k] for k in AP_KEYS},
        "per_scenario_card": {k: v for k, v in card.items() if k != "COMBINED"},
        "per_scenario_cpu": {k: v for k, v in cpu.items() if k != "COMBINED"},
        "gate": "PASS" if ok else "FAIL",
    }
    print("chip_ap_gate:", json.dumps(
        {k: artifact[k] for k in ("device", "ap_card", "ap_cpu", "abs_diff",
                                  "identical", "ap_card_bf16", "gate")}))
    if opt.archive:
        os.makedirs(os.path.dirname(opt.archive) or ".", exist_ok=True)
        with open(opt.archive, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"archived the gate artifact to {opt.archive}")
    return artifact


if __name__ == "__main__":
    sys.exit(0 if main()["gate"] == "PASS" else 1)
