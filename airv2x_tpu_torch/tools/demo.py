"""End-to-end synthetic demo: train the tiny Where2comm and evaluate it
through the port's own CLIs (counterpart of airv2x_tpu/tools/demo.py).

    python -m airv2x_tpu_torch.tools.demo [--epochs 130] [--steps 50]
        [--log_dir logs] [--archive DIR] [--num_scenes 16] [--seed 0]
        [--device cuda|cpu]

Trains ``hypes_yaml/test/tiny_where2comm.yaml`` on synthetic scenes with
``tools/train.py`` (the demo recipe: ``--epochs`` epochs of ``--steps``
steps, the lr decays moved to 70 / 130 and 110 / 130 of the run, a
checkpoint and a validation pass every thirteenth of it), then scores the
run dir with ``tools/inference_multi_scenario.py`` and writes
``demo_summary.json`` there (the COMBINED AP and whether each is above
0.2). ``--archive`` copies the evidence (results, loss curves, config,
summary) to that directory; by default it stays in the run dir only.
``--epochs 1 --steps 2`` is a smoke run.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import shutil

from airv2x_tpu_torch.config import load_yaml, save_yaml
from airv2x_tpu_torch.tools import inference_multi_scenario, train

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="airv2x_tpu_torch synthetic demo")
    p.add_argument("--epochs", type=int, default=130)
    p.add_argument("--steps", type=int, default=50, help="steps per epoch")
    p.add_argument("--log_dir", type=str, default="logs")
    p.add_argument("--archive", type=str, default="",
                   help="directory to copy the gate evidence into; empty = "
                   "leave it in the run dir only")
    p.add_argument("--num_scenes", type=int, default=16, help="eval scenes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train, evaluate, summarise; returns the summary with the run dir."""
    opt = parse_args(argv)
    hypes = load_yaml(os.path.join(REPO, "hypes_yaml/test/tiny_where2comm.yaml"))
    hypes["train_params"]["epoches"] = opt.epochs
    hypes["train_params"]["save_freq"] = max(opt.epochs // 13, 1)
    hypes["train_params"]["eval_freq"] = max(opt.epochs // 13, 1)
    hypes["lr_scheduler"]["step_size"] = [
        max(int(opt.epochs * 70 / 130), 1), max(int(opt.epochs * 110 / 130), 2)]
    os.makedirs(opt.log_dir, exist_ok=True)
    cfg_path = os.path.join(opt.log_dir, "demo_where2comm.yaml")
    save_yaml(hypes, cfg_path)

    run_dir = train.main(["--hypes_yaml", cfg_path, "--log_dir", opt.log_dir,
                          "--steps_per_epoch", str(opt.steps), "--seed", str(opt.seed),
                          "--synthetic", "--device", opt.device])
    print(f"demo run dir: {run_dir}")
    inference_multi_scenario.main(["--model_dir", run_dir, "--num_scenes",
                                   str(opt.num_scenes), "--device", opt.device])

    combined = None
    with open(os.path.join(run_dir, "results.txt")) as f:
        for line in f:
            if line.startswith("COMBINED:"):
                # a plain dict literal: never execute code from a run dir
                combined = ast.literal_eval(line.split(":", 1)[1].strip())
    if combined is None:
        raise RuntimeError("inference wrote no COMBINED line")
    gate = {k: combined[k] for k in ("ap_30", "ap_50", "ap_70")}
    summary = {
        "epochs": opt.epochs, "steps_per_epoch": opt.steps,
        "obj_threshold": hypes["postprocess"]["target_args"]["obj_threshold"],
        "ap": gate, "gate": "PASS" if min(gate.values()) > 0.2 else "FAIL"}
    with open(os.path.join(run_dir, "demo_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("demo summary:", json.dumps(summary))

    if opt.archive:
        os.makedirs(opt.archive, exist_ok=True)
        for name in ("results.txt", "train_loss.txt", "validation_loss.txt",
                     "config.yaml", "demo_summary.json"):
            src = os.path.join(run_dir, name)
            if os.path.isfile(src):
                shutil.copy(src, os.path.join(opt.archive, name))
        print(f"archived gate evidence to {opt.archive}")
    return dict(summary, run_dir=run_dir)


if __name__ == "__main__":
    main()
