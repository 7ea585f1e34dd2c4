"""The program's own spans in the traced run's trace: the `gridgcn/` spans
that `gridgcn_torch.utils.profiling.annotate` opens while a profiler
records (`request#<n>` around each `Predictor` call, then `copy_in`,
`gridconv{i}` with CAGQ's `voxelize`, `sample`, `gather`, the draws'
`jaxrng`, `group` and `gca`, `up{i}` with `knn3`, `head`, `fetch`).

The trace (`build/portbench/trace.json` under the checkout that holds the
calling reader's file) is parsed once per run, and only where the harness
accepted it (`run.trace` is not None). On each launching thread the spans
nest by containment; a span's path is its name and its ancestors' names
from the request down, the request's number left out. Every device record
(kernel, memcpy, memset) goes to the path of the innermost span open on the
launching thread when the host launched it, matched by the launch's
`correlation` (a CUDA-graph replay's kernels carry the replay launch's, so
they fall inside the span that replayed them); every gap in the device's
busy union goes to the innermost span open at the gap's middle, on the
launching thread whose innermost span started last. Work and gaps under
no span go to the empty path, "(outside the program)".

A program that opens none of these spans gives no reading: every reader
then returns None."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import re
from pathlib import Path

from harness import readers, tracing
from harness.cell import TRACE_FILE

PREFIX = "gridgcn/"
OUTSIDE = "(outside the program)"
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Row:
    """What one span path holds, per path and not counting its children's
    paths: device seconds and kernels launched with it innermost, device
    idle seconds charged to it, its spans' host seconds less their child
    spans', and how many spans it counts."""
    device_s: float = 0.0
    kernels: int = 0
    idle_s: float = 0.0
    host_self_s: float = 0.0
    spans: int = 0


@dataclasses.dataclass
class Split:
    iters: int                  # requests traced (the harness's count)
    rows: dict                  # {path (a tuple of names): Row}
    requests: list              # the request numbers seen, in order

    def holds(self, within) -> bool:
        """Whether a span path for which within(path) was traced."""
        return any(within(p) for p in self.rows)

    def total(self, field: str, within) -> float:
        """The sum of `field` over the paths for which within(path)."""
        return sum(getattr(r, field) for p, r in self.rows.items()
                   if within(p))

    def per_request(self, field: str, within) -> float:
        return self.total(field, within) / self.iters

    def parts(self, field: str, within, scale: float = 1.0) -> str:
        """The paths that `per_request(field, within)` sums, each with its
        part (times `scale`), on one line."""
        return "; ".join(
            f"{'/'.join(p) or OUTSIDE} "
            f"{scale * getattr(r, field) / self.iters!r}"
            for p, r in self.rows.items() if within(p))

    def table(self) -> str:
        """Per path, per request: device ms and kernels launched inside
        it (children included), idle ms charged to it alone and with its
        children, host self ms, spans."""
        lines = [f"program spans, per request over {self.iters} traced "
                 f"(requests {self.requests}): path | device ms | kernels "
                 "| idle ms (self) | idle ms (with children) | host self ms "
                 "| spans"]
        for p, row in self.rows.items():
            def under(q, p=p):          # () holds no other path
                return q[:len(p)] == p if p else not q
            lines.append(
                f"  {'/'.join(p) or OUTSIDE} | "
                f"{1e3 * self.per_request('device_s', under)!r} | "
                f"{self.per_request('kernels', under)!r} | "
                f"{1e3 * row.idle_s / self.iters!r} | "
                f"{1e3 * self.per_request('idle_s', under)!r} | "
                f"{1e3 * row.host_self_s / self.iters!r} | "
                f"{row.spans / self.iters!r}")
        return "\n".join(lines)


def has(name: str):
    """within(path) for the paths that pass through span `name`."""
    return lambda p: name in p


def in_layer(path: tuple) -> bool:
    """Whether a path passes through an encoder layer's span,
    `gridconv{i}`."""
    return any(re.fullmatch(r"gridconv\d+", n) for n in path)


def unspanned(path: tuple) -> bool:
    """Work under no span of the program but the request's own."""
    return path in ((), ("request",))


# the last split read: {"trace": the harness's TraceRecord, "path": the
# trace file, "split": …}, so that a run's readers parse its trace once
_cache: dict = {}


def split(run, reader_file: str, within):
    """The program's split of the serving run's trace, or None: a run of
    another driver, a trace the harness refused, or one without a span
    path for which within(path) (a program without those spans)."""
    tr = readers.traced(run, "serve")
    if tr is None:
        return None
    path = Path(reader_file).resolve().parents[2] / TRACE_FILE
    if _cache.get("trace") is not tr or _cache.get("path") != path:
        _cache.update(trace=tr, path=path, split=read(str(path), tr.iters))
    s = _cache["split"]
    return s if s is not None and s.holds(within) else None


def _name(ev: dict) -> str:
    """A span's name without the prefix, a request without its number."""
    n = ev["name"][len(PREFIX):]
    return n.split("#")[0]


def read(path: str, iters: int):
    """The split of the Chrome trace at `path` of `iters` requests; None
    where it holds no program span."""
    with open(path) as f:
        events = [ev for ev in json.load(f)["traceEvents"]
                  if ev.get("ph") == "X"]
    return split_events(events, iters)


def split_events(events: list, iters: int):
    """The split of a trace's complete events (see `read`)."""
    spans = collections.defaultdict(list)    # tid -> [(s, e, name)]
    requests = []
    for ev in events:
        if (ev.get("cat") == "user_annotation"
                and ev["name"].startswith(PREFIX)):
            s = tracing._ps(ev["ts"])
            spans[ev["tid"]].append((s, s + tracing._ps(ev["dur"]),
                                     _name(ev)))
            if "#" in ev["name"]:
                requests.append((s, int(ev["name"].split("#")[1])))
    if not spans:
        return None

    rows: dict = collections.defaultdict(Row)
    nodes = {tid: _nodes(sp, rows) for tid, sp in spans.items()}

    device = [ev for ev in events if ev.get("cat") in
              tracing.DEVICE_CATEGORIES]
    launches = {}                        # correlation -> (tid, ts)
    for ev in events:
        if ev.get("cat") in LAUNCH_CATEGORIES:
            launches[ev["args"].get("correlation")] = (
                ev["tid"], tracing._ps(ev["ts"]))
    for ev in device:
        tid, t = launches.get(ev["args"].get("correlation"), (None, None))
        hit = _open_at(nodes.get(tid), t)
        row = rows[hit[1] if hit else ()]
        row.device_s += ev["dur"] / 1e6
        row.kernels += ev["cat"] == "kernel"

    per_dev = collections.defaultdict(list)
    for ev in device:
        s = tracing._ps(ev["ts"])
        per_dev[ev["args"].get("device", 0)].append(
            (s, s + tracing._ps(ev["dur"]), ev["name"]))
    launchers = {tid for tid, _ in launches.values() if tid in nodes}
    for evs in per_dev.values():
        u = tracing.union_intervals(evs)
        for a, b in zip(u, u[1:]):
            if b[0] > a[1]:
                mid = (a[1] + b[0]) // 2
                rows[_latest(nodes, launchers, mid)].idle_s += \
                    (b[0] - a[1]) / 1e12
    rows.setdefault((), Row())
    return Split(iters=iters, rows=dict(rows),
                 requests=[n for _, n in sorted(requests)])


@dataclasses.dataclass
class _Nodes:
    starts: list                # span starts, sorted
    spans: list                 # (start, end, path, parent's index or -1)


def _nodes(sp: list, rows: dict) -> _Nodes:
    """One thread's spans with their paths and parents, nested by
    containment; adds each span's host self time and count to `rows`."""
    sp.sort(key=lambda x: (x[0], -x[1]))
    out, stack = [], []                  # stack: indices into out
    child_ps = collections.defaultdict(int)
    for s, e, name in sp:
        while stack and out[stack[-1]][1] <= s:
            stack.pop()
        parent = stack[-1] if stack else -1
        path = (out[parent][2] if stack else ()) + (name,)
        if stack:
            child_ps[parent] += e - s
        stack.append(len(out))
        out.append((s, e, path, parent))
        rows[path].spans += 1
    for j, (s, e, path, _) in enumerate(out):
        rows[path].host_self_s += (e - s - child_ps[j]) / 1e12
    return _Nodes([s for s, _, _, _ in out], out)


def _open_at(nodes: _Nodes | None, t) -> tuple | None:
    """The innermost span open at t as (start, path), or None: from the
    last span started by t up through its ancestors, the first that has
    not ended."""
    if nodes is None or t is None:
        return None
    j = bisect.bisect_right(nodes.starts, t) - 1
    while j >= 0:
        s, e, path, parent = nodes.spans[j]
        if t < e:
            return s, path
        j = parent
    return None


def _latest(nodes: dict, tids, t) -> tuple:
    """The path of the innermost span open at t on the thread whose
    innermost open span started last; () where none is open."""
    hits = [h for h in (_open_at(nodes[tid], t) for tid in tids) if h]
    return max(hits)[1] if hits else ()
