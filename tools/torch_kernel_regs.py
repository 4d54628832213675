"""Compares the compiled kernels of two checkouts: registers, spills and
machine code.

Each checkout's ``csrc/arma_ne*.cu`` (the per-order instantiations of
the one-pass and LM-fit kernels and the cost kernels; ``--sources``
names another prefix, e.g. ``hw_sse`` for the Holt-Winters kernels)
compiles with the port's nvcc flags
plus ``-Xptxas -v``, one nvcc a source, all started together; the tool
reads each kernel's registers, stack frame and spill bytes from ptxas's
report and hashes each kernel's SASS (``cuobjdump -sass``).  On a machine
with the CUDA toolkit, from the root of the repository::

    git archive <commit> | tar -x -C build/parent
    python3 tools/torch_kernel_regs.py build/parent . \
        --match arma_lm_fit arma_ne_kernel
    python3 tools/torch_kernel_regs.py build/parent . --sources hw_sse \
        --match hw_sse_kernel hw_box_fit_kernel

Prints one JSON line per checkout (its kernels whose mangled name
contains one of ``--match``: registers, stack, spill stores and loads,
SASS hash) and a last line that lists the kernels whose registers,
spills or SASS differ between the first checkout and each other one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _compile(root: str, out: str, prefix: str):
    from spark_timeseries_tpu_torch import _build

    csrc = os.path.join(root, "spark_timeseries_tpu_torch", "csrc")
    srcs = sorted(f for f in os.listdir(csrc)
                  if f.startswith(prefix) and f.endswith(".cu"))
    procs = []
    for src in srcs:
        obj = os.path.join(out, src + ".o")
        procs.append((obj, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             "-o", obj, os.path.join(csrc, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs = [], []
    for obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed in {root}:\n{log}")
        logs.append(log)
        objs.append(obj)
    return "\n".join(logs), objs


def _name(mangled: str) -> str:
    """A kernel's mangled name without its anonymous namespace's tag,
    which carries a hash of the file that defines it, so that the same
    kernel of two checkouts has one name."""
    return re.sub(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}",
                  "(anonymous)", mangled)


def _ptxas(log: str):
    """Kernel -> registers, stack, spill stores / loads from ptxas -v."""
    props, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = _name(m.group(1))
            props.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            props[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            props[name]["registers"] = int(m.group(1))
    return props


def _sass(objs):
    """Kernel -> sha256 of its SASS."""
    out = {}
    for obj in objs:
        text = subprocess.run(["cuobjdump", "-sass", obj], check=True,
                              capture_output=True, text=True).stdout
        for block in re.split(r"\n\s*Function : ", text)[1:]:
            name, _, body = block.partition("\n")
            out[_name(name.strip())] = \
                hashlib.sha256(body.encode()).hexdigest()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="checkouts to compare")
    ap.add_argument("--sources", default="arma_ne",
                    help="compile the csrc/*.cu files with this prefix")
    ap.add_argument("--match", nargs="+", default=["arma_lm_fit"],
                    help="compare the kernels whose name contains one of "
                         "these")
    args = ap.parse_args(argv)
    tables = []
    for root in args.roots:
        with tempfile.TemporaryDirectory() as out:
            log, objs = _compile(root, out, args.sources)
            regs, sass = _ptxas(log), _sass(objs)
        table = {n: dict(regs.get(n, {}), sass=sass.get(n))
                 for n in sorted(set(regs) | set(sass))
                 if any(m in n for m in args.match)}
        tables.append(table)
        print(json.dumps({"root": root, "kernels": len(table),
                          "table": table}), flush=True)
    base = tables[0]
    diff = {root: sorted(n for n in set(base) | set(t)
                         if base.get(n) != t.get(n))
            for root, t in zip(args.roots[1:], tables[1:])}
    print(json.dumps({"match": args.match, "kernels": len(base),
                      "differ": diff}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
