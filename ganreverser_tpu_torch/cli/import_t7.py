"""Import a Torch7 checkpoint from the reference implementation — the
counterpart of ganreverser_tpu/cli/import_t7.py, with its flags.

The reference trains and saves with Torch7's binary serializer
(train.lua:256, train_r.lua:234, pretrain_g.lua:202,
pretrain_with_previous_net.lua:265). This command converts any of those
``*.net`` files into this framework's checkpoint format so existing
trained networks carry over:

    python -m ganreverser_tpu_torch.cli.import_t7 logs/adversarial.net \\
        --out logs
    python -m ganreverser_tpu_torch.cli.import_t7 \\
        logs/r_1x32x32_nd32_normal.net --out logs

The produced checkpoints are drop-in for --network/--G/--R on every CLI of
either package (resume, apply_r, sample, show). Layout is auto-detected
from the saved table's keys ({G,D,...} adversarial / {R,opt} reverser /
{G,opt,EPOCH} pretrained decoder / {G,D,opt} distilled pair). Optimizer
moments start fresh, matching the reference's own resume behavior
(train.lua:110-125 restores nets only). Needs no device.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> str:
    """Convert the file; returns the checkpoint path. A structural
    mismatch exits with a message naming it."""
    p = argparse.ArgumentParser(
        description="convert a reference Torch7 *.net checkpoint "
                    "(train.lua/train_r.lua/pretrain_*.lua save files) "
                    "into a framework checkpoint directory")
    p.add_argument("input", help="path to the .net/.t7 file")
    p.add_argument("--out", default="logs",
                   help="directory to write the checkpoint under "
                        "(named like the matching trainer would)")
    p.add_argument("--height", type=int, default=0,
                   help="override/supply the image height (needed only "
                        "for non-square R files, whose opt has no "
                        "geometry — train_r.lua:12-29)")
    p.add_argument("--width", type=int, default=0,
                   help="override/supply the image width")
    args = p.parse_args(argv)

    from ..io.import_t7 import ImportError7, import_t7
    try:
        return import_t7(args.input, args.out, height=args.height or None,
                         width=args.width or None)
    except ImportError7 as e:
        sys.exit(f"[import_t7] structural mismatch: {e}")


if __name__ == "__main__":
    main()
