"""Write a config with its derived parameters filled in (counterpart of
airv2x_tpu/tools/config_generate.py).

    python -m airv2x_tpu_torch.tools.config_generate --hypes_yaml <in> --output <out>
"""

from __future__ import annotations

import argparse

from airv2x_tpu_torch.config import load_yaml, save_yaml


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="materialise a derived config")
    p.add_argument("--hypes_yaml", required=True)
    p.add_argument("--output", required=True)
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    save_yaml(load_yaml(opt.hypes_yaml), opt.output)
    print(f"derived config written to {opt.output}")


if __name__ == "__main__":
    main()
