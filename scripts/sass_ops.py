#!/usr/bin/env python3
"""Count the machine instructions (SASS) of the port's CUDA kernels.

    python3 scripts/sass_ops.py [--dump PATH] [--same-as OTHER_DUMP [--changed REGEX]]

Builds the kernel library of ``dxt_lossless_transform_tpu_torch`` if needed (nvcc),
disassembles it with ``cuobjdump -sass`` and prints one JSON object: for each
kernel, its instructions by class, and for each loop (a backward branch and the
instructions it jumps back over) the same counts. ``chip_smoke.py`` takes its
integer-operation counts per item from this output; ``--dump`` also writes the
whole disassembly to PATH. ``--same-as`` reads another build's ``--dump`` (of a
parent commit, say) and adds which of its kernels have no twin here, instruction
for instruction (opcodes and operands, addresses aside), whatever their names;
``--changed`` names (a regular expression over the mangled names) the kernels that
a change meant to alter, and the script exits 1 when any other kernel lost its twin.

Classes: ``alu`` is per-thread integer and logic work (IADD3, LOP3, SHF, ISETP,
IMAD, LEA, PRMT, SEL, MOV, ...); ``uniform`` runs once per warp on the uniform
datapath (U-prefixed opcodes); ``shared``/``global``/``const`` are loads, stores
and atomics by space; ``control`` is branches, barriers and the like. Needs
nvcc and cuobjdump (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_CONTROL = ("BRA", "EXIT", "BAR", "BSSY", "BSYNC", "NOP", "RET", "CALL", "WARPSYNC",
            "YIELD", "BPT", "MEMBAR", "DEPBAR", "CCTL", "ERRBAR", "JMP", "BREAK",
            "VOTE", "NANOSLEEP")


def _classify(op: str) -> str:
    base = op.split(".")[0]
    if base.startswith("U"):
        return "uniform"
    if base in ("LDS", "STS", "ATOMS", "LDSM"):
        return "shared"
    if base in ("LDG", "STG", "ATOMG", "RED", "ATOM", "LD", "ST"):
        return "global"
    if base in ("LDC",):
        return "const"
    if base in _CONTROL:
        return "control"
    if base in ("S2R", "S2UR", "CS2R"):
        return "special"
    return "alu"


def _count(insns) -> dict:
    out = {"all": len(insns)}
    for _, op, _ in insns:
        cls = _classify(op)
        out[cls] = out.get(cls, 0) + 1
    return out


def bodies(sass: str) -> dict:
    """{kernel name: [(opcode, operands), ...]} from ``cuobjdump -sass``, without
    the end-of-code padding."""
    out, name = {}, None
    for line in sass.splitlines():
        f = _FUNC.search(line)
        if f:
            name = f.group(1)
            out[name] = []
            continue
        m = _INSN.search(line)
        if m and name is not None:
            out[name].append((m.group(2), m.group(3).strip()))
    for body in out.values():
        while body and body[-1][0] in ("NOP", "BRA"):
            body.pop()
    return out


def parse(sass: str) -> dict:
    """{kernel name: {"counts": ..., "loops": [...]}} from ``cuobjdump -sass``."""
    kernels = {}
    name, insns = None, []

    def close():
        if name is None:
            return
        body = list(insns)
        while body and body[-1][1] in ("NOP", "BRA"):  # the end-of-code padding
            body.pop()
        loops = []
        for addr, op, args in body:
            m = re.search(r"0x([0-9a-f]+)", args)
            if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
                target = int(m.group(1), 16)
                span = [x for x in body if target <= x[0] <= addr]
                loops.append({"from": hex(target), "to": hex(addr), **_count(span)})
        kernels[name] = {"counts": _count(body), "loops": loops}

    for line in sass.splitlines():
        f = _FUNC.search(line)
        if f:
            close()
            name, insns = f.group(1), []
            continue
        m = _INSN.search(line)
        if m and name is not None:
            insns.append((int(m.group(1), 16), m.group(2), m.group(3)))
    close()
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", help="also write the whole disassembly here")
    ap.add_argument("--same-as", help="another build's --dump: report its kernels "
                                      "that have no instruction-for-instruction twin")
    ap.add_argument("--changed", help="with --same-as: the kernels that may lose their "
                                      "twin (a regular expression); any other fails")
    args = ap.parse_args()
    from dxt_lossless_transform_tpu_torch import backend

    path, _ = backend.build()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    if args.dump:
        with open(args.dump, "w") as f:
            f.write(sass)
    kernels = parse(sass)
    if not kernels:
        raise SystemExit("sass_ops: no kernel found in the disassembly")
    out = {"library": os.path.basename(path), "kernels": kernels}
    if args.same_as:
        with open(args.same_as) as f:
            other = bodies(f.read())
        mine = {tuple(body) for body in bodies(sass).values()}
        lost = [name for name, body in other.items() if tuple(body) not in mine]
        out["same_as"] = {"dump": args.same_as, "kernels": len(other), "without_twin": lost}
        if args.changed is not None:
            out["same_as"]["unexpected"] = [name for name in lost
                                            if not re.search(args.changed, name)]
    print(json.dumps(out, indent=1))
    return 1 if out.get("same_as", {}).get("unexpected") else 0


if __name__ == "__main__":
    sys.exit(main())
