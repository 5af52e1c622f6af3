"""Strip vertex colors from .ply files (benchmark submissions want
geometry-only clouds).

Counterpart of `rcmvsnet_tpu/cli/rm_color.py`, on the port's `core/io`.

Usage: python -m rcmvsnet_tpu_torch.cli.rm_color --input_dir D [--output_dir O]
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..core.io import load_ply, save_ply


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", default=None)
    args = p.parse_args(argv)
    in_dir = Path(args.input_dir)
    out_dir = Path(args.output_dir or in_dir / "no_color")
    out_dir.mkdir(parents=True, exist_ok=True)
    for ply in sorted(in_dir.glob("*.ply")):
        xyz, _ = load_ply(ply)
        save_ply(out_dir / ply.name, xyz, rgb=None)
        print(f"{ply} -> {out_dir / ply.name} ({len(xyz)} pts)")


if __name__ == "__main__":
    main()
