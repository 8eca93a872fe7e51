"""Which instructions the built kernels execute: a census of their SASS.

    python -m vil_tpu_torch.tools.sass_census [--match full_attention]

Builds the kernel library if needed (``ops/kernels/build.py``), disassembles
it with ``cuobjdump -sass`` from the CUDA toolkit and prints, for every kernel
whose name holds ``--match``, how many instructions of each class its code
holds (static counts, not executions; each of the library's cubins
disassembled by its own ``cuobjdump``, all at once): tensor-core products (HGMMA is
``wgmma``, HMMA ``mma.sync``), asynchronous copies into shared memory (LDGSTS
is ``cp.async``, UTMALDG a TMA load), f32 fused multiply-adds on the CUDA
cores (FFMA), and shared-memory loads (LDS), and the registers a thread of
it uses, from the compiler's report beside the library (``-Xptxas -v``).
``chip_smoke.py`` calls :func:`census` after its build.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from ..ops.kernels import build

CLASSES = ("HGMMA", "HMMA", "LDGSTS", "UTMALDG", "FFMA", "LDS")
_FUNCTION = re.compile(r"Function : (\S+)")
# an instruction of CLASSES: its address, its predicate if any, its opcode
# (modifiers after a dot)
_COUNTED = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?(" + "|".join(CLASSES)
                      + r")(?![A-Z0-9_])")
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_REGISTERS = re.compile(r"Used (\d+) registers")


def registers(report: str) -> dict[str, int]:
    """{mangled kernel name: registers a thread} from ptxas's ``-v`` report."""
    found, current = {}, None
    for line in report.splitlines():
        entry = _ENTRY.search(line)
        if entry:
            current = entry.group(1)
            continue
        used = _REGISTERS.search(line)
        if current is not None and used:
            found[current] = int(used.group(1))
            current = None
    return found


def _tool(name: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which(name), os.path.join(cuda_home, "bin", name)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found: it comes with the CUDA toolkit")


def _demangle(names: list[str]) -> dict[str, str]:
    try:
        tool = _tool("cu++filt")
    except RuntimeError:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out))


def kernel_name(demangled: str) -> str:
    """A kernel's name and template arguments from cu++filt's line, which
    spells an int or bool template argument with its cast ("(int)64",
    "(bool)1"): the casts dropped before the parameter list is cut."""
    return re.sub(r"\((?:int|bool)\)", "", demangled).split("(")[0].replace("void ", "")


def count_classes(sass: str) -> dict[str, dict[str, int]]:
    """{mangled kernel name: {instruction class: count}} of ``cuobjdump
    -sass`` output."""
    counts: dict[str, dict[str, int]] = {}
    pieces = _FUNCTION.split(sass)  # [preamble, name, code, name, code, ...]
    for name, code in zip(pieces[1::2], pieces[2::2]):
        current = counts.setdefault(name, dict.fromkeys(CLASSES, 0))
        for op in _COUNTED.findall(code):
            current[op] += 1
    return counts


def disassemble(lib: Path) -> str:
    """``cuobjdump -sass`` of every cubin in ``lib``, one process a cubin,
    all at once."""
    tool = _tool("cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([tool, "-xelf", "all", str(lib)], cwd=tmp, capture_output=True,
                       check=True)
        cubins = sorted(Path(tmp).glob("*.cubin"))
        if not cubins:
            raise RuntimeError(f"cuobjdump found no cubin in {lib}")
        procs = [subprocess.Popen([tool, "-sass", str(c)], stdout=subprocess.PIPE, text=True)
                 for c in cubins]
        outs = [proc.communicate()[0] for proc in procs]
        if any(proc.returncode for proc in procs):
            raise RuntimeError(f"cuobjdump -sass failed on {lib}'s cubins")
    return "".join(outs)


def census(match: str = "full_attention") -> dict[str, dict[str, int | None]]:
    """{kernel name: {instruction class: count, "registers": registers a
    thread (None without the compiler's report)}} for the kernels whose
    demangled name holds ``match``."""
    lib = build.build()
    counts = count_classes(disassemble(lib))
    report = lib.with_suffix(".log")
    regs = registers(report.read_text()) if report.exists() else {}
    names = {k: kernel_name(v) for k, v in _demangle(list(counts)).items()}
    return {names[k]: {**v, "registers": regs.get(k)} for k, v in counts.items()
            if match in names[k]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--match", default="full_attention")
    args = ap.parse_args()
    for name, counts in sorted(census(args.match).items()):
        print(f"{name:55s} " + " ".join(f"{k} {v}" for k, v in counts.items()))


if __name__ == "__main__":
    main()
