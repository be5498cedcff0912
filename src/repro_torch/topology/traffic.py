"""Collective statistics and the program graph G_p of a lowered step.

The paper's information graph (vertices = processes, edge weights c_kp =
communication intensity) of a training or serving step: every collective
op contributes traffic between the logical devices of its replica groups
according to its ring / pairwise pattern.  The port's own steps record
their collectives as :class:`CollectiveOp`s directly
(``parallel.collectives.record_collectives``); :func:`parse_collectives`
reads them from SPMD-partitioned HLO text, as the reference does.  A
direct port of the reference's ``repro/topology/traffic.py`` (``re`` and
numpy only), its arithmetic included: :func:`total_collective_bytes`
truncates its float sum with ``int`` (an all-gather of 12 x 128 bytes
over a group of 11 totals 15359, not the ring's 15360).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
}

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")

_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w\.\-]+\s*=\s*"
    r"(?:\(?(?P<outs>[^)=]*)\)?)\s*"
    r"(?P<kind>all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(", re.M)

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{(\{[^}]*\}(?:,\{[^}]*\})*)\}")
_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=(?:\[([\d,]+)\])?"
                      r"(?:T\(([\d,]+)\))?(?:\[(\d+)\])?")
_PAIRS_RE = re.compile(r"source_target_pairs=\{((?:\{\d+,\d+\},?)+)\}")


@dataclass
class CollectiveOp:
    kind: str
    bytes: int                      # per-participant payload bytes
    groups: List[List[int]]         # replica groups (logical device ids)


def _shape_bytes(shape_str: str) -> int:
    """Sum of bytes over all array shapes in a type string."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _parse_groups(line: str, num_devices: int) -> Optional[List[List[int]]]:
    m = _GROUPS_RE.search(line)
    if m:
        return [[int(x) for x in g.split(",") if x]
                for g in re.findall(r"\{([^}]*)\}", m.group(1))]
    m = _IOTA_RE.search(line)
    if m:
        g, s = int(m.group(1)), int(m.group(2))
        total = g * s
        base = np.arange(total)
        if m.group(3):  # iota dims with optional transpose
            dims = [int(x) for x in m.group(3).split(",")]
            if int(np.prod(dims)) == total:
                base = base.reshape(dims)
                perm_str = m.group(4)
                if perm_str:
                    perm = [int(x) for x in perm_str.split(",")]
                    if len(perm) == base.ndim:
                        base = base.transpose(perm)
                base = base.reshape(-1)
        return base.reshape(g, s).tolist()
    m = _PAIRS_RE.search(line)
    if m:
        pairs = re.findall(r"\{(\d+),(\d+)\}", m.group(1))
        return [[int(a), int(b)] for a, b in pairs]
    return None


def parse_collectives(hlo_text: str, num_devices: int) -> List[CollectiveOp]:
    ops: List[CollectiveOp] = []
    for line in hlo_text.splitlines():
        m = _OP_RE.match(line)
        if not m or "-done" in line.split("=", 1)[-1][:40]:
            continue
        kind = m.group("kind")
        nbytes = _shape_bytes(m.group("outs") or "")
        if nbytes == 0:
            nbytes = _shape_bytes(line.split("(", 1)[-1])
        groups = _parse_groups(line, num_devices)
        if groups is None:
            groups = [list(range(num_devices))]
        ops.append(CollectiveOp(kind=kind, bytes=nbytes, groups=groups))
    return ops


def _wire_bytes(op: CollectiveOp) -> float:
    """Per-participant wire bytes.  ``op.bytes`` is the HLO *result* size,
    which is the full tensor for all-gather/all-reduce but the scattered
    shard for reduce-scatter (hence the x g correction)."""
    g = max((len(gr) for gr in op.groups), default=1)
    if op.kind == "collective-permute":
        return op.bytes
    if op.kind == "all-reduce":
        return 2.0 * op.bytes * (g - 1) / max(g, 1)      # ring reduce+bcast
    if op.kind == "reduce-scatter":
        return op.bytes * (g - 1)                        # result is 1/g of input
    return op.bytes * (g - 1) / max(g, 1)                # all-gather / all-to-all


def total_collective_bytes(ops: List[CollectiveOp]) -> int:
    """Sum of wire bytes across participants (roofline numerator)."""
    total = 0.0
    for op in ops:
        if op.kind == "collective-permute":
            total += op.bytes * len(op.groups)           # groups = (src, dst) pairs
        else:
            total += _wire_bytes(op) * sum(len(g) for g in op.groups)
    return int(total)


def traffic_matrix(ops: List[CollectiveOp], num_devices: int) -> np.ndarray:
    """Program graph C: bytes exchanged between logical device pairs.

    Ring collectives put traffic on consecutive pairs in group order (the
    order GSPMD schedules them); all-to-all spreads uniformly; permutes are
    explicit pairs.
    """
    c = np.zeros((num_devices, num_devices), np.float64)
    for op in ops:
        if op.kind == "collective-permute":
            for src, dst in op.groups:
                if src < num_devices and dst < num_devices:
                    c[src, dst] += op.bytes
            continue
        for g in op.groups:
            g = [d for d in g if d < num_devices]
            n = len(g)
            if n < 2:
                continue
            if op.kind == "all-to-all":
                per_pair = op.bytes / n
                for i in g:
                    for j in g:
                        if i != j:
                            c[i, j] += per_pair
            else:
                per_hop = _wire_bytes(op)
                for idx in range(n):
                    a, b = g[idx], g[(idx + 1) % n]
                    c[a, b] += per_hop
    return c.astype(np.float32)
