"""Whether the lens kernels' bf16 builds compile to the same machine code
as another tree's, read on the card's toolchain.

    python3 -m taboo_brittleness_tpu_torch.perf.sass_compare --base DIR

DIR is the root of another checkout (an unpacked ``git archive`` of the
parent commit, say).  Each lens source under ``csrc/`` of both trees is
compiled with the wrapper's own flags to a cubin (``nvcc -cubin``), its
SASS listed by ``cuobjdump -sass``, and each kernel function's
instructions compared with addresses and encodings left out.  A kernel is
matched across the trees by its name with the input type's template
argument (``__nv_bfloat16``) dropped and its anonymous namespace (named
per translation unit) left out, so a kernel that gained a type parameter
is compared with its old self; functions only one tree has (``float``
and ``__half`` builds, helpers) are listed apart.  Prints one line per kernel
and one JSON line; exits non-zero without ``nvcc`` or ``cuobjdump``.  Where
two kernels differ, the count of differing instructions is also given with
the targets of branches and calls left out (``other``): a kernel whose
only differences are targets runs the same instructions in the same order,
laid out at other addresses.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

BF16_ARG = "13__nv_bfloat16"
# Control flow whose operand is an address in the function.
TARGET = re.compile(r"^((?:@!?U?P\w+\s+)?(?:BRA|BSSY|CALL|JMP|JMX|BRX)\S*\s.*?)"
                    r"0x[0-9a-f]+$")
# A kernel's mangled name: its own name and its template arguments.
KERNEL = re.compile(r"(lens_[a-z_]+_kernel)I(.*?)EEv")


def kernel_key(mangled: str) -> str:
    """``name<template arguments>`` with the bf16 argument dropped, or the
    mangled name of a function that is no lens kernel."""
    m = KERNEL.search(mangled)
    return f"{m.group(1)}<{m.group(2).replace(BF16_ARG, '')}>" if m else mangled
CUBIN_FLAGS = tuple(f for f in lk.NVCC_FLAGS
                    if f not in ("-shared", "-Xcompiler", "-fPIC"))


def _cuobjdump() -> str:
    found = os.path.join(os.path.dirname(lk._nvcc()), "cuobjdump")
    if not os.path.exists(found):
        found = shutil.which("cuobjdump")
    if found is None:
        raise SystemExit("cuobjdump not found beside nvcc or on PATH")
    return found


def sass_by_function(source: str, workdir: str) -> dict:
    """{function name: [instructions]} of one source's cubin."""
    cubin = os.path.join(workdir, os.path.basename(source) + ".cubin")
    subprocess.run([lk._nvcc(), *CUBIN_FLAGS, "-cubin", "-o", cubin, source],
                   check=True, capture_output=True, text=True)
    listing = subprocess.run([_cuobjdump(), "-sass", cubin], check=True,
                             capture_output=True, text=True).stdout
    out, name = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = kernel_key(m.group(1))
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and name:
            out[name].append(m.group(1))
    return out


def compare(base_root: str) -> dict:
    rows = {}
    with tempfile.TemporaryDirectory(prefix="sass_") as tmp:
        for route, source in lk.SOURCES.items():
            rel = os.path.relpath(source, os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(lk.__file__)))))
            base_src = os.path.join(base_root, rel)
            os.makedirs(os.path.join(tmp, "base"), exist_ok=True)
            os.makedirs(os.path.join(tmp, "new"), exist_ok=True)
            base = sass_by_function(base_src, os.path.join(tmp, "base"))
            new = sass_by_function(source, os.path.join(tmp, "new"))
            for name in sorted(set(base) | set(new)):
                if name in base and name in new:
                    same = base[name] == new[name]
                    pairs = list(zip(base[name], new[name]))
                    diff = [i for i, (a, b) in enumerate(pairs) if a != b]
                    other = [i for i in diff
                             if TARGET.sub(r"\1<target>", pairs[i][0])
                             != TARGET.sub(r"\1<target>", pairs[i][1])]
                    rows[name] = dict(route=route, equal=same,
                                      base=len(base[name]), new=len(new[name]),
                                      differing=len(diff) + abs(len(base[name])
                                                                - len(new[name])),
                                      other=len(other),
                                      first=[(i, *pairs[i]) for i in
                                             (other or diff)[:3]])
                else:
                    rows[name] = dict(route=route, only="base" if name in base
                                      else "new")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="root of the checkout to compare with")
    args = ap.parse_args(argv)
    rows = compare(args.base)
    for name, r in rows.items():
        if "only" in r:
            # tbx: TBX009-ok — CLI stdout contract (one line per kernel)
            print(f"{r['route']}: {name}: only in the {r['only']} tree")
        else:
            # tbx: TBX009-ok — CLI stdout contract (one line per kernel)
            print(f"{r['route']}: {name}: {'equal' if r['equal'] else 'DIFFERS'}"
                  f" ({r['base']} / {r['new']} instructions, {r['differing']} "
                  f"differ, {r['other']} other than targets)" + "".join(f"; #{i}: {a!r} / {b!r}"
                                      for i, a, b in r["first"]))
    both = [r for r in rows.values() if "only" not in r]
    # tbx: TBX009-ok — CLI stdout contract (results JSON)
    print(json.dumps({"compared": len(both),
                      "equal": sum(r["equal"] for r in both), "kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
