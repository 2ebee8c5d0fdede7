"""Instruction counts of a kernel's frame loop, from its SASS.

``ncu`` does not run on the card's host, but the toolkit's ``cuobjdump``
does: :func:`dump` disassembles a built library, and
:func:`loop_classes` counts the instructions of one kernel's innermost
loop (its largest loop that holds no other) along its main path, in five
classes (:func:`body_classes` the same for a kernel's whole body, from
its first instruction to an ``EXIT``, each loop body once):

- ``fp32``: FP32 arithmetic, compares and selects;
- ``conv``: conversions, roundings and the special-function unit (I2F,
  F2I, FRND, F2F, MUFU, ...), the pipe that issues 16 results a clock
  per SM where FP32 issues 128;
- ``mem``: loads and stores (global, shared, constant, local);
- ``int``: integer, address, predicate and move instructions;
- ``branch``: branches and convergence (BRA, BSSY, BSYNC, CALL, ...).

The main path is the path through the loop body, from its head to its
back edge, that issues the most global loads (the taps), with one
MUFU instruction a pixel-frame for a homography instance and none for
an affine one (the reciprocal's fast path in line; a fallback that
divides again has more), and otherwise the fewest instructions: it
skips the plain-expression fallbacks a kernel keeps for pixels on the
frame's edge.  The counts are static, per loop iteration;
``per_pixel`` divides them by the iteration's pixel-frames.  With
``longest`` the path with the most instructions is taken instead of the
fewest (a kernel whose threads share one body, as B3d's blurring
threads do: its busiest thread).
"""

from __future__ import annotations

import functools
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

CLASSES = ("fp32", "conv", "mem", "int", "branch")

_CONV = {"I2F", "I2FP", "F2I", "F2IP", "FRND", "F2F", "MUFU", "I2I", "F2FP"}
_MEM = {"LDG", "LDS", "LDC", "ULDC", "STG", "STS", "LD", "ST", "LDL", "STL",
        "LDSM", "ATOM", "ATOMS", "RED", "LDGSTS", "LDGDEPBAR"}
_BRANCH = {"BRA", "BRX", "JMP", "JMX", "BSSY", "BSYNC", "CALL", "RET", "EXIT",
           "WARPSYNC", "BAR", "BREAK", "YIELD", "KILL", "NOP"}
_FP32 = {"FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FSET", "FCHK",
         "FADD32I", "FMUL32I", "FFMA32I", "FSWZADD"}

_INSN = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:(@!?U?P[T0-9]+)\s+)?"
                   r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)([^;]*);")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_LABEL = re.compile(r"^\s*(\.L_[\w$]+):")
_TARGET = re.compile(r"`\((\.L_[\w$]+)\)|\b0x([0-9a-f]+)\b")


def classify(op: str) -> str:
    """The class of opcode ``op`` (no modifiers)."""
    if op in _CONV:
        return "conv"
    if op in _MEM:
        return "mem"
    if op in _BRANCH:
        return "branch"
    if op in _FP32:
        return "fp32"
    return "int"


def cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(path).exists():
        raise RuntimeError("cuobjdump not found (PATH or /usr/local/cuda/bin)")
    return path


def dump(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library."""
    return subprocess.run([cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def functions(sass: str) -> Dict[str, str]:
    """Mangled kernel name -> its SASS text."""
    out: Dict[str, str] = {}
    name, lines = None, []
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            if name:
                out[name] = "\n".join(lines)
            name, lines = m.group(1), []
        elif name:
            lines.append(line)
    if name:
        out[name] = "\n".join(lines)
    return out


def _parse(text: str) -> List[dict]:
    """The instructions in address order, each with its opcode, class,
    predicate and branch target address (labels resolved)."""
    insns, labels, pending = [], {}, []
    for line in text.splitlines():
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        op, mods, rest = m.group(3), m.group(4), m.group(5)
        insns.append(dict(addr=addr, op=op, full=op + mods, cls=classify(op),
                          pred=m.group(2), rest=rest))
    for ins in insns:
        ins["target"] = None
        if ins["op"] in ("BRA", "BSSY", "CALL", "JMP", "BREAK"):
            t = _TARGET.search(ins["rest"])
            if t:
                ins["target"] = (labels.get(t.group(1)) if t.group(1)
                                 else int(t.group(2), 16))
        # predicated, or a branch on a (uniform) predicate operand
        ins["cond"] = bool(ins["pred"] and ins["pred"] != "@PT") or (
            ins["op"] == "BRA"
            and re.search(r"U?P[0-9]", ins["rest"].split("`")[0]) is not None)
    return insns


def _innermost_loop(insns: List[dict]):
    """(head index, back-edge index) of the largest loop that holds no
    other loop."""
    index = {ins["addr"]: i for i, ins in enumerate(insns)}
    loops = [(index[ins["target"]], i) for i, ins in enumerate(insns)
             if ins["op"] == "BRA" and ins["target"] is not None
             and ins["target"] <= ins["addr"] and ins["target"] in index]
    inner = [(h, e) for h, e in loops
             if not any(h <= h2 and e2 <= e and (h2, e2) != (h, e)
                        for h2, e2 in loops)]
    if not inner:
        return None
    return max(inner, key=lambda he: he[1] - he[0])


def loop_classes(text: str, pixels: int = 1,
                 homography: bool = True) -> Optional[dict]:
    """Counts by class (and by opcode) along the main path of one
    kernel's innermost loop (``text``: its SASS, from :func:`functions`;
    ``pixels`` the pixel-frames an iteration), with ``static`` the loop
    body's instruction count and ``per_pixel`` the class counts divided
    by ``pixels``; None if the kernel has no loop.  Where several paths
    carry the most loads, ``homography`` takes the one with ``pixels``
    MUFU, else the one with none."""
    insns = _parse(text)
    loop = _innermost_loop(insns)
    if loop is None:
        return None
    head, end = loop
    return _main_path(insns[head:end + 1], pixels, homography,
                      closes_loop=True)


def body_classes(text: str, pixels: int = 1, homography: bool = True,
                 longest: bool = False) -> Optional[dict]:
    """:func:`loop_classes` for a kernel's whole body: the main path from
    the kernel's first instruction to an ``EXIT``, forward edges only, so
    a loop's body counts once (``pixels`` the output values a thread;
    ``longest`` the path with the most instructions)."""
    insns = _parse(text)
    if not insns:
        return None
    return _main_path(insns, pixels, homography, closes_loop=False,
                      longest=longest)


def _main_path(body: List[dict], pixels: int, homography: bool,
               closes_loop: bool, longest: bool = False) -> Optional[dict]:
    """The counts of the main path through ``body``: from its head to its
    back edge (``closes_loop``) or to an ``EXIT``, forward edges only;
    among paths with the most global loads and the MUFU count closest to
    the target, the fewest instructions (the most with ``longest``)."""
    addr = {ins["addr"]: i for i, ins in enumerate(body)}
    # leaders of basic blocks: the head, branch targets, after branches
    lead = {0}
    for i, ins in enumerate(body):
        if ins["target"] is not None and ins["target"] in addr:
            lead.add(addr[ins["target"]])
        if ins["op"] in ("BRA", "EXIT", "RET", "BSYNC", "CALL", "BREAK"):
            lead.add(i + 1)
    starts = sorted(x for x in lead if x < len(body))
    blocks = [(s, (starts + [len(body)])[k + 1]) for k, s in enumerate(starts)]
    block_of = {s: k for k, (s, _) in enumerate(blocks)}
    # best[k][mufu]: ((LDG, -instructions), counts by opcode) of the best
    # path from the head to block k's start with that many MUFU
    # (+instructions with ``longest``)
    step = 1 if longest else -1
    best: List[dict] = [dict() for _ in blocks]
    best[0][0] = ((0, 0), {})
    ends: dict = {}

    def offer(table, mufu, score, ops):
        if mufu not in table or score > table[mufu][0]:
            table[mufu] = (score, ops)

    for k, (s, e) in enumerate(blocks):
        for mufu, ((ldg, neg), ops) in list(best[k].items()):
            ops = dict(ops)
            for ins in body[s:e]:
                ops[ins["full"]] = ops.get(ins["full"], 0) + 1
                ldg += ins["op"] == "LDG"
                mufu += ins["op"] == "MUFU"
                neg += step
            last = body[e - 1]
            succ = []
            if not closes_loop and last["op"] == "EXIT":
                offer(ends, mufu, (ldg, neg), ops)
            if last["op"] == "BRA" and last["target"] is not None:
                if closes_loop and last["target"] == body[0]["addr"]:
                    offer(ends, mufu, (ldg, neg), ops)
                elif last["target"] in addr and addr[last["target"]] > e - 1:
                    succ.append(block_of[addr[last["target"]]])
            if not (last["op"] in ("BRA", "EXIT", "RET") and not last["cond"]):
                if e < len(body):
                    succ.append(block_of[e])
            for t in succ:
                offer(best[t], mufu, (ldg, neg), ops)
    if not ends:
        return None
    want = pixels if homography else 0
    mufu = max(ends, key=lambda m: (ends[m][0][0], -abs(m - want),
                                      ends[m][0][1]))
    ops = ends[mufu][1]
    counts = {c: 0 for c in CLASSES}
    for full, n in ops.items():
        counts[classify(full.split(".")[0])] += n
    return dict(counts=counts, total=sum(counts.values()), ops=ops,
                static=len(body), pixel_frames=pixels, mufu=mufu,
                per_pixel={c: counts[c] / pixels for c in CLASSES},
                per_pixel_total=sum(counts.values()) / pixels)


@functools.lru_cache(maxsize=None)
def _library_functions(lib: Path) -> Dict[str, str]:
    return functions(dump(lib))


def kernel_loop(lib: Path, piece: str, pixels: int = 1,
                homography: bool = True, whole: bool = False,
                longest: bool = True) -> Optional[dict]:
    """:func:`loop_classes` of the kernel of library ``lib`` whose
    mangled name contains ``piece`` (None if there is none); ``whole``:
    a path through its whole body (:func:`body_classes`), the longest (a
    busiest thread) or, with ``longest`` False, the main path (a
    loop-free kernel's fast path).  A library is disassembled once."""
    funcs = _library_functions(Path(lib))
    name = next((k for k in funcs if piece in k), None)
    if name is None:
        return None
    if whole:
        found = body_classes(funcs[name], pixels, homography, longest)
    else:
        found = loop_classes(funcs[name], pixels, homography)
    if found is not None:
        found["kernel"] = name
    return found


def fmt(found: Optional[dict]) -> str:
    """One line: the per-pixel-frame counts by class."""
    if not found:
        return "no SASS loop found"
    pp = found["per_pixel"]
    return (f"{found['per_pixel_total']:.1f} instructions a pixel-frame on "
            f"the main path (" + ", ".join(f"{c} {pp[c]:.1f}" for c in CLASSES)
            + f"; {found['pixel_frames']} pixel-frames an iteration, "
            f"{found['mufu']} MUFU on the path, loop body {found['static']} "
            f"static)")
