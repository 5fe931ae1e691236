"""The program's own spans in the traced window (`utils/profiling.span` in
the port, recorded by the window's profiler among the host ops): each
span's self time, and the device's idle time put down to the innermost
span over each instant of each gap.

A program span is a host op named `tick`, `run` or `train`, or starting
with one of them and a dot.  Its self time is its duration less the part
its child program spans cover; aten ops and CUDA runtime calls are no
children.  A reader that finds no span returns None, never 0."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

ROOTS = ("tick", "run", "train")
_CHILDREN = tuple(r + "." for r in ROOTS)


def is_span(name: str) -> bool:
    return name in ROOTS or name.startswith(_CHILDREN)


def _spans(trace) -> List[Tuple[float, float, str]]:
    """(start_s, end_s, name) of the program spans, parents before their
    children."""
    return sorted(((s, s + d, n) for n, s, d in trace.host_ops
                   if is_span(n)), key=lambda x: (x[0], -x[1]))


def _pieces(spans) -> List[Tuple[float, float, str]]:
    """The window cut into (start_s, end_s, name) pieces on each of which
    the innermost program span is `name`; time under no span is in no
    piece.  A span that outlasts its parent is clipped to it."""
    pieces, stack, t = [], [], 0.0

    def close_to(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, name = stack.pop()
            if end > t:
                pieces.append((t, end, name))
            t = max(t, end)

    for start, end, name in spans:
        close_to(start)
        if stack and start > t:
            pieces.append((t, start, stack[-1][1]))
        stack.append((min(end, stack[-1][0]) if stack else end, name))
        t = max(t, start)
    close_to(float("inf"))
    return pieces


def stats(trace) -> Dict[str, Tuple[int, float, float]]:
    """Per span name: (count, self seconds, device-idle seconds under it as
    the innermost span)."""
    spans = _spans(trace)
    pieces = _pieces(spans)
    out: Dict[str, List[float]] = {}
    for _, _, name in spans:
        out.setdefault(name, [0, 0.0, 0.0])[0] += 1
    for start, end, name in pieces:
        out[name][1] += end - start
    gaps = sorted((s, s + d) for s, d in trace.idle_gaps)
    i = 0
    for start, end, name in pieces:
        while i < len(gaps) and gaps[i][1] <= start:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < end:
            out[name][2] += min(end, gaps[j][1]) - max(start, gaps[j][0])
            j += 1
    return {k: (int(c), s, idle) for k, (c, s, idle) in out.items()}


def self_ms_per(trace, names, per: str) -> Optional[float]:
    """The summed self time of spans `names`, in ms per `per` span; None
    where the trace holds no `per` span or none of `names`."""
    st = stats(trace)
    n = st.get(per, (0,))[0]
    if not n or not any(name in st for name in names):
        return None
    return 1e3 * sum(st[name][1] for name in names if name in st) / n


def idle_ms_per(trace, root: str, leave_out, per: str) -> Optional[float]:
    """Device-idle ms per `per` span under the spans `root` and `root.*`,
    but not under those named in `leave_out`; None where the trace holds
    no `per` span or no device op."""
    st = stats(trace)
    n = st.get(per, (0,))[0]
    if not n or trace.busy_s <= 0:
        return None
    idle = sum(v[2] for k, v in st.items()
               if (k == root or k.startswith(root + "."))
               and k not in leave_out)
    return 1e3 * idle / n

