"""Trip-count-aware HLO cost model.

XLA's ``compiled.cost_analysis()`` counts a ``while`` body ONCE, so any
program with `lax.scan` (our layer stacks, attention chunking, loss
chunking) under-reports FLOPs/bytes by the trip count.  The optimized HLO
text, however, annotates every while with ``"known_trip_count":{"n":K}``.
This module parses the text into a computation call graph, multiplies each
computation's cost by the product of enclosing trip counts, and reports:

  * flops          -- 2*M*N*K for every dot (incl. dots inside fusions)
  * hbm_bytes      -- operand+result bytes of every top-level instruction in
                      *control-flow* computations (fusion internals excluded:
                      a fusion's HBM traffic is its operands + results)
  * collectives    -- CollectiveOp list with trip multipliers applied

All numbers are per-device (the HLO is the SPMD-partitioned module).
A direct port of the reference's ``repro/topology/hlocost.py`` (``re``
and numpy only).  Nothing on the card produces HLO: this module serves
``launch.placement.traffic_from_compiled`` when a caller hands it HLO
text or an object with ``.as_text()``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .traffic import CollectiveOp, _parse_groups, _shape_bytes, COLLECTIVE_KINDS

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16, "token": 0, "opaque": 0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_TRIP_RE = re.compile(r'known_trip_count\\?":\{\\?"n\\?":\\?"(\d+)')

# ops whose operands/results don't move HBM bytes
_FREE_OPS = {"parameter", "constant", "tuple", "get-tuple-element", "bitcast",
             "after-all", "partition-id", "replica-id", "iota", "copy-start",
             "copy-done"}


def _type_bytes(type_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _first_shape_dims(type_str: str) -> List[int]:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return []
    return [int(d) for d in m.group(2).split(",") if d]


@dataclass
class Instruction:
    name: str
    type_str: str
    op: str
    args: str            # inside the call parens
    attrs: str           # after the call parens
    line: str


@dataclass
class Computation:
    name: str
    instructions: List[Instruction] = field(default_factory=list)
    symbols: Dict[str, str] = field(default_factory=dict)   # name -> type str


_COMP_HEADER = re.compile(r"^(ENTRY\s+)?%?([\w\.\-]+)\s*\((?:[^()]|\([^()]*\))*\)\s*->")
_INSTR_RE = re.compile(r"^\s+(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(.*)$")


def _split_type_op(rhs: str) -> Optional[Tuple[str, str, str, str]]:
    """rhs like 'bf16[2,3]{1,0} dot(%a, %b), attrs' -> (type, op, args, attrs)."""
    rhs = rhs.strip()
    if rhs.startswith("("):
        depth = 0
        for i, c in enumerate(rhs):
            depth += c == "("
            depth -= c == ")"
            if depth == 0:
                type_str, rest = rhs[:i + 1], rhs[i + 1:].strip()
                break
        else:
            return None
    else:
        sp = rhs.find(" ")
        if sp < 0:
            return None
        type_str, rest = rhs[:sp], rhs[sp + 1:].strip()
    m = re.match(r"([\w\-]+)\(", rest)
    if not m:
        return None
    op = m.group(1)
    depth = 0
    start = m.end() - 1
    for i in range(start, len(rest)):
        depth += rest[i] == "("
        depth -= rest[i] == ")"
        if depth == 0:
            return type_str, op, rest[start + 1:i], rest[i + 1:]
    return type_str, op, rest[start + 1:], ""


def parse_module(text: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for line in text.splitlines():
        if cur is None:
            m = _COMP_HEADER.match(line.strip())
            if m and line.rstrip().endswith("{"):
                cur = Computation(name=m.group(2))
            continue
        if line.startswith("}"):
            comps[cur.name] = cur
            cur = None
            continue
        m = _INSTR_RE.match(line)
        if not m:
            continue
        parsed = _split_type_op(m.group(2))
        if parsed is None:
            continue
        type_str, op, args, attrs = parsed
        inst = Instruction(name=m.group(1), type_str=type_str, op=op,
                           args=args, attrs=attrs, line=line)
        cur.instructions.append(inst)
        cur.symbols[inst.name] = type_str
    return comps


def _called_comps(inst: Instruction) -> List[Tuple[str, str]]:
    """(role, computation) pairs referenced by control-flow/fusion attrs."""
    out = []
    for role in ("body", "condition", "calls", "to_apply", "branch_computations",
                 "true_computation", "false_computation"):
        for m in re.finditer(role + r"=\{?%?([\w\.\-]+(?:,\s*%?[\w\.\-]+)*)\}?",
                             inst.attrs):
            for name in re.split(r",\s*", m.group(1)):
                out.append((role, name.lstrip("%")))
    return out


def _trip_count(inst: Instruction) -> int:
    m = _TRIP_RE.search(inst.attrs)
    return int(m.group(1)) if m else 1


def _param_names_in_order(comp: Computation) -> List[str]:
    out: Dict[int, str] = {}
    for inst in comp.instructions:
        if inst.op == "parameter":
            m = re.match(r"\s*(\d+)", inst.args)
            if m:
                out[int(m.group(1))] = inst.name
    return [out[i] for i in sorted(out)]


def _effective_param_bytes(comp: Computation) -> Dict[str, float]:
    """Per-parameter effective HBM read bytes inside a fusion computation.

    A parameter consumed only by ``dynamic-slice`` reads just the slice per
    execution (the classic scan-xs pattern); counting the full operand every
    iteration overstates traffic by the trip count.  A parameter consumed by
    ``dynamic-update-slice`` as the destination is written in place (bytes ~
    the update operand, counted via the result correction below).
    """
    eff: Dict[str, float] = {}
    for p in _param_names_in_order(comp):
        full = _type_bytes(comp.symbols.get(p, ""))
        uses = [i for i in comp.instructions
                if re.search(r"%" + re.escape(p) + r"\b", i.args)]
        if uses and all(u.op == "dynamic-slice" for u in uses):
            eff[p] = sum(_type_bytes(u.type_str) for u in uses)
        elif uses and all(u.op == "dynamic-update-slice" and
                          re.match(r"\s*%" + re.escape(p) + r"\b", u.args)
                          for u in uses):
            eff[p] = 0.0      # in-place destination: writes counted at root
        else:
            eff[p] = full
    return eff


def _fusion_result_bytes(comp: Computation, default: float) -> float:
    """If the fusion root is a dynamic-update-slice, the write traffic is the
    update operand, not the full carried tensor."""
    root = comp.instructions[-1] if comp.instructions else None
    for inst in comp.instructions:
        if inst.line.lstrip().startswith("ROOT"):
            root = inst
            break
    if root is not None and root.op == "dynamic-update-slice":
        ops = re.findall(r"%([\w\.\-]+)", root.args)
        if len(ops) >= 2:
            upd = _type_bytes(comp.symbols.get(ops[1], ""))
            if upd:
                return 2.0 * upd          # read-modify-write of the window
    return default


def _dot_flops(inst: Instruction, comp: Computation) -> float:
    result_elems = float(np.prod(_first_shape_dims(inst.type_str) or [0]))
    # Scheduled modules print operand types inline ("f32[8,64]{1,0} %lhs");
    # match the first %name and fall back to the inline type if the symbol
    # table misses it.
    lhs_m = re.search(r"(?:(\w+\[[\d,]*\](?:\{[^}]*\})?)\s+)?%([\w\.\-]+)",
                      inst.args) or re.match(r"\s*([\w\.\-]+)()", inst.args)
    contract = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", inst.attrs)
    if not lhs_m or not contract or result_elems == 0:
        return 0.0
    lhs_type = comp.symbols.get(lhs_m.group(2) or lhs_m.group(1)) or lhs_m.group(1)
    if not lhs_type:
        return 0.0
    lhs_dims = _first_shape_dims(lhs_type)
    k = 1.0
    for d in contract.group(1).split(","):
        if d:
            if int(d) >= len(lhs_dims):
                return 0.0
            k *= lhs_dims[int(d)]
    return 2.0 * result_elems * k


@dataclass
class HloCost:
    flops: float
    hbm_bytes: float
    collective_ops: List[CollectiveOp]      # with trip multipliers applied
    collective_bytes: float
    by_collective: Dict[str, Dict[str, float]]


def analyze(text: str, num_devices: int) -> HloCost:
    comps = parse_module(text)

    entry = None
    for line in text.splitlines():
        if line.startswith("ENTRY"):
            m = _COMP_HEADER.match(line.strip())
            if m:
                entry = m.group(2)
                break
    if entry is None or entry not in comps:           # fallback: flat count
        entry = max(comps, key=lambda c: len(comps[c].instructions), default=None)

    # multiplier propagation over the call DAG
    mult: Dict[str, float] = {name: 0.0 for name in comps}
    fusion_internal: Dict[str, bool] = {name: False for name in comps}
    mult[entry] = 1.0
    order = [entry]
    seen = {entry}
    i = 0
    while i < len(order):
        cname = order[i]
        i += 1
        comp = comps[cname]
        for inst in comp.instructions:
            trip = _trip_count(inst) if inst.op == "while" else 1
            for role, callee in _called_comps(inst):
                if callee not in comps:
                    continue
                w = trip if role == "body" else 1
                mult[callee] += mult[cname] * w
                if role in ("calls", "to_apply") and inst.op == "fusion":
                    fusion_internal[callee] = True
                if callee not in seen:
                    seen.add(callee)
                    order.append(callee)

    flops = 0.0
    hbm = 0.0
    coll_ops: List[CollectiveOp] = []
    coll_bytes = 0.0
    by_kind: Dict[str, Dict[str, float]] = {}

    from .traffic import _wire_bytes
    for cname, comp in comps.items():
        m = mult.get(cname, 0.0)
        if m == 0.0:
            continue
        internal = fusion_internal.get(cname, False)
        for inst in comp.instructions:
            if inst.op == "dot":
                flops += m * _dot_flops(inst, comp)
            kind = inst.op.replace("-start", "")
            if kind in COLLECTIVE_KINDS and not inst.op.endswith("-done"):
                nbytes = _type_bytes(inst.type_str)
                groups = _parse_groups(inst.line, num_devices) or \
                    [list(range(num_devices))]
                op = CollectiveOp(kind=kind, bytes=nbytes, groups=groups)
                coll_ops.extend([op] * int(max(m, 1)))
                if kind == "collective-permute":
                    wire = nbytes * len(groups)
                else:
                    wire = _wire_bytes(op) * sum(len(g) for g in op.groups)
                coll_bytes += m * wire
                d = by_kind.setdefault(kind, {"count": 0.0, "bytes": 0.0})
                d["count"] += m
                d["bytes"] += m * nbytes
            if internal or inst.op in _FREE_OPS:
                continue
            operand_names = [om.group(1) for om in
                             re.finditer(r"%([\w\.\-]+)", inst.args)]
            if inst.op == "fusion":
                callee = next((c for r, c in _called_comps(inst)
                               if r == "calls" and c in comps), None)
                if callee is not None:
                    fcomp = comps[callee]
                    eff = _effective_param_bytes(fcomp)
                    pnames = _param_names_in_order(fcomp)
                    b = _fusion_result_bytes(fcomp, _type_bytes(inst.type_str))
                    for pos, on in enumerate(operand_names):
                        key = pnames[pos] if pos < len(pnames) else None
                        if key is not None and key in eff:
                            b += eff[key]
                        else:
                            t = comp.symbols.get(on)
                            b += _type_bytes(t) if t else 0
                    hbm += m * b
                    continue
            if inst.op == "dynamic-slice":
                hbm += m * 2 * _type_bytes(inst.type_str)
                continue
            if inst.op == "dynamic-update-slice":
                upd = comp.symbols.get(operand_names[1]) if \
                    len(operand_names) >= 2 else None
                hbm += m * 2 * (_type_bytes(upd) if upd else
                                _type_bytes(inst.type_str))
                continue
            b = _type_bytes(inst.type_str)
            for on in operand_names:
                t = comp.symbols.get(on)
                if t:
                    b += _type_bytes(t)
            hbm += m * b
    return HloCost(flops=flops, hbm_bytes=hbm, collective_ops=coll_ops,
                   collective_bytes=coll_bytes, by_collective=by_kind)
