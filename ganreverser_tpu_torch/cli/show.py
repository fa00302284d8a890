"""Checkpoint inspector CLI — show_model_content.lua, the counterpart of
ganreverser_tpu/cli/show.py: the same text for the same checkpoint, either
package's (only the converter named in a Torch7 file's last line is this
package's).

Prints the config, metadata, and a tree summary (leaf shapes/dtypes/param
counts) of any framework checkpoint, or the module tree of a reference
Torch7 ``.net``/``.t7`` file.

Usage:  python -m ganreverser_tpu_torch.cli.show logs/adversarial \
            [--plot [out.png]]

``--plot`` renders the checkpoint's persisted loss history (plot_data,
train.lua:256 — the reference can only view it by resuming with a display
server) as a PNG chart via io/plots.py.
"""
from __future__ import annotations

import os
import sys

from ..io import checkpoint as gio
from ..models.modules import count_parameters


def _summary(tree, prefix="", depth=0, max_depth=3):
    lines = []
    if isinstance(tree, dict) and depth < max_depth:
        for k, v in tree.items():
            lines += _summary(v, f"{prefix}/{k}", depth + 1, max_depth)
    elif hasattr(tree, "shape"):
        lines.append(f"  {prefix}: {tuple(tree.shape)} {tree.dtype}")
    else:
        n = count_parameters(tree) if isinstance(tree, dict) else "?"
        lines.append(f"  {prefix}: ... ({n} params)")
    return lines


def _t7_module_summary(obj, depth=0, lines=None):
    from ..io.torch7 import TorchObject, table_to_list
    lines = [] if lines is None else lines
    if not isinstance(obj, TorchObject):
        return lines
    pieces = []
    w = obj.get("weight")
    if hasattr(w, "shape"):
        pieces.append(f"weight {tuple(w.shape)}")
    if hasattr(obj.get("bias"), "shape"):
        pieces.append(f"bias {tuple(obj['bias'].shape)}")
    lines.append("  " * depth + f"  {obj.torch_class}"
                 + (f" [{', '.join(pieces)}]" if pieces else ""))
    if "modules" in obj:
        for child in table_to_list(obj["modules"]):
            _t7_module_summary(child, depth + 1, lines)
    return lines


def _show_t7(path: str):
    """Inspect a reference Torch7 save file (show_model_content.lua's
    input format) without converting it."""
    from ..io import torch7
    top = torch7.load(path)
    print(f"== Torch7 file: {path}")
    if not isinstance(top, dict):
        print(f"-- top-level object: {top!r}")
        return
    for k in sorted(k for k in top if isinstance(k, str)):
        v = top[k]
        if hasattr(v, "torch_class") and "modules" in v:
            print(f"-- {k}: {v.torch_class}")
            for line in _t7_module_summary(v):
                print(line)
        elif hasattr(v, "shape"):
            print(f"-- {k}: tensor {tuple(v.shape)} {v.dtype}")
        elif isinstance(v, dict):
            print(f"-- {k}: table with {len(v)} entries")
            for kk in sorted(v, key=str):
                vv = v[kk]
                print(f"   {kk} = "
                      + (f"<{type(vv).__name__}>"
                         if isinstance(vv, (dict, list)) or
                         hasattr(vv, "torch_class") else repr(vv)))
        else:
            print(f"-- {k} = {v!r}")
    print("-- convert with: python -m ganreverser_tpu_torch.cli.import_t7 "
          f"{path} --out <dir>")


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    plot_to = None
    if "--plot" in argv:
        # render the checkpoint's persisted loss history (plot_data,
        # train.lua:256 — which the reference saves but can only view by
        # resuming with a display server) to a PNG chart
        i = argv.index("--plot")
        has_path = i + 1 < len(argv) and not argv[i + 1].startswith("-")
        plot_to = argv[i + 1] if has_path else "plot_data.png"
        del argv[i:i + 2 if has_path else i + 1]
    if not argv:
        sys.exit("usage: show <checkpoint-dir | reference .net/.t7 file> "
                 "[--plot [out.png]]")
    path = argv[0]
    if os.path.isfile(path):
        # a reference Torch7 save file — show_model_content.lua:14 inspects
        # these directly, so this CLI does too (read-only; convert with
        # cli/import_t7 to actually use it)
        return _show_t7(path)
    tree, config, extra = gio.load_checkpoint(path)
    print(f"== checkpoint: {path}")
    plot_data = extra.get("plot_data") if isinstance(extra, dict) else None
    extra_show = dict(extra) if isinstance(extra, dict) else extra
    if plot_data:
        extra_show["plot_data"] = f"<{len(plot_data)} rows>"
    print(f"-- extra: {extra_show}")
    if plot_to is not None:
        if plot_data:
            from ..io.plots import save_chart
            # label by the checkpoint's CONTENT, not row width: train_r's
            # [batch, low, avg, high] rows are the same width as train's
            # [epoch, D loss, G loss, D acc]
            if isinstance(tree, dict) and "R" in tree:
                labels = ["batch", "R loss (low)", "R loss (avg)",
                          "R loss (high)"]
            elif isinstance(tree, dict) and "G" in tree and "D" in tree:
                labels = ["epoch", "D loss", "G loss", "D acc"]
            elif len(plot_data[0]) == 2:
                labels = ["epoch", "G Loss"]  # pretrain_g history
            else:
                labels = ["step"] + [f"series {i}"
                                     for i in range(1, len(plot_data[0]))]
            save_chart(plot_to, plot_data, labels[:len(plot_data[0])],
                       title=f"loss history: {path}")
            print(f"-- plot_data chart written to {plot_to}")
        else:
            print("-- no plot_data in this checkpoint; nothing to plot")
    print("-- config:")
    for k in sorted(config):
        print(f"   {k} = {config[k]}")
    print("-- contents:")
    for line in _summary(tree):
        print(line)
    for name in ("G", "D", "R"):
        if isinstance(tree, dict) and name in tree and "params" in tree[name]:
            print(f"-- {name}: {count_parameters(tree[name]['params'])} "
                  "parameters")


if __name__ == "__main__":
    main()
