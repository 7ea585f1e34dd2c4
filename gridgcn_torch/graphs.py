"""The served forward replayed from CUDA graphs, cut at the program's spans.

An eager forward on the card has the host dispatch each of its ~1600–2100
kernels; a replay launches a few graphs instead. `Signatures` keeps one
device's replays by request signature: a signature's first call is the
caller's own eager forward (`seen` says so), its second is captured
(`capture`) and replayed, and every later call replays, so a shape seen
once never pays for a capture. At most `MAX_SIGNATURES` are kept; the
least recently used is dropped with its graphs and their memory pool.

`capture(fn, kit)` runs fn() once with its kernels captured. At each entry
and exit of a program span (`utils.profiling.annotate`) the graph being
captured ends and the next begins, so that each segment holds the work
between two span boundaries; it is kept with the spans open around it
(each span's name and which entry of a span it was), and a segment that
holds no work is dropped. `Plan.replay()` replays the segments in capture
order inside the same spans, opened by the same `annotate` calls: a shared
no-op untraced, a `record_function` while a profiler records. A replayed
kernel carries its graph launch's correlation in a trace, so it is charged
to the span that the eager forward launched it in. The segments share one
memory pool: they are replayed whole and in capture order.

`kit` makes the segments: `new()` gives a graph with `begin()`, `end()`
(→ whether it holds work) and `replay()`, and `capturing()` is the context
the capture runs in. `CudaGraphs` is the card's kit.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import warnings

import torch

from gridgcn_torch.utils import profiling

MAX_SIGNATURES = 4      # signatures a Signatures keeps, least recent dropped
# what torch warns at the end of a capture that holds no work
_EMPTY_WARNING = "The CUDA Graph is empty"
_OPEN, _CLOSE, _REPLAY = range(3)


@dataclasses.dataclass
class Segment:
    spans: tuple        # ((entry, name), ...) open around it, outermost first
    graph: object

    @property
    def path(self) -> tuple:
        """The names of the spans open around the segment."""
        return tuple(name for _, name in self.spans)


class Plan:
    """A captured forward: its segments, replayed inside their spans, and
    its output, which each replay overwrites."""

    def __init__(self, segments: list, output):
        self.segments = segments
        self.output = output
        steps, open_ = [], ()
        for seg in segments:
            k = 0
            while k < min(len(open_), len(seg.spans)) and \
                    open_[k] == seg.spans[k]:
                k += 1
            steps += [(_CLOSE, None)] * (len(open_) - k)
            steps += [(_OPEN, name) for _, name in seg.spans[k:]]
            steps.append((_REPLAY, seg.graph.replay))
            open_ = seg.spans
        self._steps = steps + [(_CLOSE, None)] * len(open_)

    def replay(self):
        entered = []
        try:
            for op, arg in self._steps:
                if op == _REPLAY:
                    arg()
                elif op == _OPEN:
                    span = profiling.annotate(arg)
                    span.__enter__()
                    entered.append(span)
                else:
                    entered.pop().__exit__(None, None, None)
        finally:
            while entered:
                entered.pop().__exit__(None, None, None)
        return self.output


class _Capture:
    """The capture in progress: `span(name)` is what `annotate` returns.
    Every graph lives until the capture ends, the empty ones too: a
    pool's last graph that goes frees the pool, which the next segment
    could then not share."""

    def __init__(self, kit):
        self.kit = kit
        self.segments = []
        self.open = []          # [(entry, name)]
        self.entries = 0
        self.graphs = [kit.new()]
        self.graph = self.graphs[0]
        self.graph.begin()

    def end(self):
        if self.graph.end():
            self.segments.append(Segment(tuple(self.open), self.graph))

    def cut(self):
        self.end()
        self.graph = self.kit.new()
        self.graphs.append(self.graph)
        self.graph.begin()

    @contextlib.contextmanager
    def span(self, name: str):
        self.cut()
        self.open.append((self.entries, name))
        self.entries += 1
        yield
        self.cut()
        self.open.pop()


def capture(fn, kit) -> Plan:
    """fn() captured into segments cut at the program's spans; fn's
    kernels do not run (replay the plan for its output)."""
    if profiling._cutter is not None:
        raise RuntimeError("a capture is already in progress")
    with kit.capturing():
        cap = _Capture(kit)
        profiling._cutter = cap
        try:
            out = fn()
        except BaseException:
            with contextlib.suppress(Exception):
                cap.graph.end()
            raise
        finally:
            profiling._cutter = None
        cap.end()
    return Plan(cap.segments, out)


class _CudaSegment:
    def __init__(self, pool):
        self.pool = pool
        self.graph = torch.cuda.CUDAGraph()
        self.replay = self.graph.replay

    def begin(self):
        self.graph.capture_begin(pool=self.pool)

    def end(self) -> bool:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            self.graph.capture_end()
        return not any(_EMPTY_WARNING in str(w.message) for w in caught)


class CudaGraphs:
    """The card's segments: `torch.cuda.CUDAGraph`s in one private memory
    pool, captured on a side stream of `device` (a capture may not run on
    the default stream)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)

    def new(self) -> _CudaSegment:
        return _CudaSegment(self.pool)

    @contextlib.contextmanager
    def capturing(self):
        torch.cuda.synchronize(self.device)
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield
        main.wait_stream(self.stream)


@dataclasses.dataclass
class _Entry:
    static: object = None
    plan: Plan | None = None


class Signatures:
    """One device's forward by request signature: the caller's eager
    forward at a signature's first call, captured at its second, replayed
    after. `captures` and `replays` count captures and replayed calls (the
    calls after a signature's second)."""

    def __init__(self, new_kit):
        self.new_kit = new_kit          # () → a kit for one capture
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.captures = 0
        self.replays = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, sig) -> bool:
        return sig in self._entries

    def seen(self, sig) -> bool:
        """Count a call of `sig`, now the most recently used: whether it
        was called before (since it was last dropped). False: the caller
        runs its eager forward, and `static` and `run` wait for the next
        call."""
        if sig in self._entries:
            self._entries.move_to_end(sig)
            return True
        self._entries[sig] = _Entry()
        while len(self._entries) > MAX_SIGNATURES:
            self._entries.popitem(last=False)
        return False

    def static(self, sig, make):
        """`sig`'s static inputs, make() at its first replayed call."""
        entry = self._entries[sig]
        if entry.static is None:
            entry.static = make()
        return entry.static

    def run(self, sig, forward):
        """The output of forward() on `sig`'s static inputs: captured and
        replayed at the signature's second call, replayed after."""
        entry = self._entries[sig]
        if entry.plan is None:
            entry.plan = capture(forward, self.new_kit())
            self.captures += 1
        else:
            self.replays += 1
        return entry.plan.replay()
