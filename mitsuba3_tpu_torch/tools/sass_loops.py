"""Count the SASS instructions of a kernel's loops.

    python3 -m mitsuba3_tpu_torch.tools.sass_loops KERNEL [LIB.so ...]

Run from the repository root on a machine with the CUDA toolkit. KERNEL is
a stem of ``mitsuba3_tpu_torch/csrc`` (``bvh_pallas_traverse``); without
libraries its shipped source is built with the shipped flags. For each
library the tool runs ``cuobjdump -sass`` and prints, per function, every
loop (a backward branch and its target) that holds no other loop: its
instruction count, the reciprocals in it (``MUFU.RCP``, one per
ray-triangle test, so an unrolled loop shows as several) and the
instructions per reciprocal, with a count by opcode. With ``--dump DIR``
it also writes each library's SASS there.
"""
from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

FUNC = re.compile(r"^\s*Function : (\S+)")
INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?);")
BRANCH = re.compile(r"\bBRA(?:\.\S+)?\s+(0x[0-9a-f]+)")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    path = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    if not path.exists():
        raise SystemExit("sass_loops: cuobjdump not found")
    return str(path)


def functions(sass: str) -> dict:
    """{function name: [(address, instruction text)]} of a SASS listing."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = FUNC.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = INSN.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def _opcode(text: str) -> str:
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def inner_loops(insns) -> list:
    """[(first address, last address, [instructions])] of the loops that
    hold no other loop."""
    loops = []
    for addr, text in insns:
        m = BRANCH.search(text)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(a, b) for a, b in loops
             if not any((a, b) != (c, d) and a <= c and d <= b
                        for c, d in loops)]
    return [(a, b, [t for x, t in insns if a <= x <= b])
            for a, b in sorted(set(inner))]


def report(name: str, sass: str) -> None:
    for fn, insns in functions(sass).items():
        for a, b, body in inner_loops(insns):
            ops = collections.Counter(_opcode(t) for t in body)
            rcp = sum(1 for t in body if "MUFU.RCP" in t)
            per = f", {len(body) / rcp:.1f} per reciprocal" if rcp else ""
            top = ", ".join(f"{k} {v}" for k, v in ops.most_common())
            print(f"# {name} {fn} loop {a:#x}-{b:#x}: {len(body)} "
                  f"instructions, {rcp} MUFU.RCP{per}: {top}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel")
    ap.add_argument("libs", nargs="*", metavar="LIB.so")
    ap.add_argument("--dump", metavar="DIR")
    args = ap.parse_args(argv)
    libs = [Path(p) for p in args.libs]
    if not libs:
        from mitsuba3_tpu_torch.ops import native
        native.build([args.kernel])
        libs = [native.library_path(args.kernel)]
    for lib in libs:
        sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        if args.dump:
            Path(args.dump).mkdir(parents=True, exist_ok=True)
            (Path(args.dump) / f"{lib.stem}.sass").write_text(sass)
        report(lib.stem, sass)
    return 0


if __name__ == "__main__":
    sys.exit(main())
