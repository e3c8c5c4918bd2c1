"""The program's own spans in a traced run (``tpuslam_torch.spans``): the
host records of ``rec["trace"]["host"]`` whose name is one of the program's
span names, and their self time (a span's duration less the part of it
that its program-span children cover). Nothing here reads a span the
program does not open: on a program without spans every list is empty."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# the program's span names, each <layer>.<stage>, and the mapper's own
FACADE = "facade.track_stereo"
NAMES = frozenset((
    FACADE,
    "frontend.upload", "frontend.extract", "frontend.stereo",
    "tracking.local_map", "tracking.track_step", "tracking.read_packed", "tracking.resolve", "tracking.keyframe",
    "local_mapping", "mp.fuse_apply", "mp.cull", "mp.triangulate", "mp.fuse_dispatch", "mp.covis", "mp.ba", "mp.kf_cull",
    "local_ba.assemble", "local_ba.solve", "local_ba.apply",
))

Span = Tuple[str, int, int]  # (name, start ns, end ns)


def program_spans(rec: Dict) -> Optional[List[Span]]:
    """The run's program spans sorted by start (a parent before the children
    it holds); None without a trace."""
    if rec.get("trace") is None:
        return None
    return sorted(((n, s, e) for n, s, e in rec["trace"]["host"] if n in NAMES), key=lambda r: (r[1], -r[2]))


def self_ns(spans: List[Span]) -> List[Tuple[Span, int]]:
    """Each span with its self time (ns): its duration less what its
    direct children cover. ``spans`` sorted as :func:`program_spans` sorts."""
    out: List[list] = []
    stack: List[list] = []
    for sp in spans:
        while stack and not (sp[1] >= stack[-1][0][1] and sp[2] <= stack[-1][0][2]):
            stack.pop()
        row = [sp, sp[2] - sp[1]]
        if stack:
            stack[-1][1] -= sp[2] - sp[1]
        stack.append(row)
        out.append(row)
    return [(sp, t) for sp, t in out]


def named(spans: List[Span], *prefixes: str) -> List[Span]:
    """The spans whose name is one of ``prefixes`` or starts with one that
    ends in a dot."""
    return [s for s in spans if any(s[0] == p or (p.endswith(".") and s[0].startswith(p)) for p in prefixes)]


def union(intervals) -> List[Tuple[int, int]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def minus(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """``a`` less ``b``, both sorted and disjoint."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def total(intervals) -> int:
    return sum(e - s for s, e in intervals)
