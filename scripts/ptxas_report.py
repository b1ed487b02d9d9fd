"""Registers, spills and spill sites of the port's CUDA kernels, from the compiler.

Compiles each ``ttt_video_dit_torch/csrc/<name>.cu`` given (default: all)
for sm_90a into a cubin in a temporary directory, with the flags of
``ops/_build.py`` plus ``-lineinfo``, prints ptxas's ``-v`` lines for every
kernel, and, from ``nvdisasm -g``, the source lines with the most local-memory
stores and loads (STL/LDL: spilled registers and arrays kept in local memory).
Needs nvcc and nvdisasm (the CUDA toolkit), not a card.

    python scripts/ptxas_report.py [ttt_mlp_forward ttt_mlp_backward ...] [--top N]
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ttt_video_dit_torch.ops import _build  # noqa: E402


def report(name: str, top: int) -> None:
    src = _build.CSRC_DIR / f"{name}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, f"{name}.cubin")
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        proc = subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", cubin, str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {src.name}:\n{proc.stderr}")
        print(f"== {name}")
        for line in proc.stderr.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  " + line.strip())
        nvdisasm = os.path.join(os.path.dirname(_build._nvcc()), "nvdisasm")
        dis = subprocess.run([nvdisasm, "-g", "-c", cubin], capture_output=True, text=True, check=True).stdout
    func = where = None
    sites = collections.Counter()
    for line in dis.splitlines():
        m = re.match(r"\s*\.text\.(\S+):", line)
        if m:
            func = m.group(1)
        m = re.search(r'//## File "([^"]+)", line (\d+)', line)
        if m:
            where = f"{os.path.basename(m.group(1))}:{m.group(2)}"
        m = re.search(r"\b(STL|LDL)\b", line)
        if m:
            sites[(func, where, m.group(1))] += 1
    for (fn, at, op), count in sites.most_common(top):
        print(f"  {count:4d} {op} {at} in {fn[:70]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help="csrc/<name>.cu to compile (default: all)")
    ap.add_argument("--top", type=int, default=12, help="spill sites to list a source")
    args = ap.parse_args()
    names = args.names or sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    for name in names:
        report(name, args.top)


if __name__ == "__main__":
    main()
