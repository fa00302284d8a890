#!/usr/bin/env python3
"""The tensor-core kernels' SASS of two checkouts of the port, function by
function: the check that a change to a shared mainloop left some of its
instances untouched.

    python3 tools/sass_diff.py --root DIR [--names wgmma_kernel,...]

Builds (or finds) the kernel library of this checkout and of the one at
``--root`` (each into its own ``build/kernels``, in a process of its own:
both packages have one name), runs ``cuobjdump -sass`` on both, drops
addresses and instruction encodings, and prints one line per function whose
mangled name holds one of ``--names`` (default: the bf16 tensor-core
kernels, ``wgmma_kernel``): ``same`` or ``DIFF``, with its HGMMA and IGMMA
counts in both, then the first differing instruction of each that differs.
Exits 1 if any differs or is missing from this build. Needs nvcc and
cuobjdump (the card's machine).
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from ganreverser_tpu_torch.ops import cuda_lib; "
         "print(cuda_lib.build())")


def library(root: str) -> str:
    """Path of ``root``'s built kernel library."""
    out = subprocess.run([sys.executable, "-c", BUILD, root], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[-1]


def functions(lib: str) -> dict:
    """Mangled name -> its SASS instructions, addresses and encodings
    dropped."""
    sys.path.insert(0, HERE)
    from ganreverser_tpu_torch.ops import cuda_lib
    sass = subprocess.run([cuda_lib.cuda_tool("cuobjdump"), "-sass", lib],
                          check=True, capture_output=True, text=True).stdout
    found, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            found[name] = []
        elif name is not None:
            text = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "",
                          line).strip()
            if text:
                found[name].append(text)
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--names", default="wgmma_kernel")
    args = ap.parse_args(argv)
    names = args.names.split(",")
    old = functions(library(os.path.abspath(args.root)))
    new = functions(library(HERE))
    picked = sorted(n for n in old if any(s in n for s in names))
    differ = []
    for name in picked:
        a, b = old[name], new.get(name)
        counts = ", ".join(
            f"{op} {sum(op in i for i in a)}/"
            f"{'-' if b is None else sum(op in i for i in b)}"
            for op in ("HGMMA", "IGMMA"))
        print(f"[sass] {'same' if a == b else 'DIFF'} {name} ({counts}, "
              "root/this)")
        if a != b:
            differ.append(name)
    for name in differ:
        a, b = old[name], new.get(name, [])
        at = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                  min(len(a), len(b)))
        print(f"[sass] {name}: {len(a)} against {len(b)} instructions, "
              f"first difference at {at}")
    print(f"[sass] {len(picked) - len(differ)} functions the same, "
          f"{len(differ)} differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
