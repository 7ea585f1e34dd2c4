"""The served forward's CUDA-graph replay (`gridgcn_torch.graphs`) on the
CPU: the segment plan under a stand-in graph (segments in span order with
their span paths, the empty ones dropped, the replay inside the same nested
spans as the eager run under the CPU profiler), the per-signature policy
(eager, then a capture at the second call, replays after, a fixed LRU cap),
the tensor-key forward that a capture runs against the numpy-key forward
for the three benchmarked presets, and the CPU and mesh Predictors, which
never replay. The replay on the card is `tests/test_torch_cuda.py`'s."""

import contextlib
import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from gridgcn_torch import graphs
from gridgcn_torch.api import Predictor
from gridgcn_torch.configs import presets
from gridgcn_torch.models import gridconv
from gridgcn_torch.models.build import init_model
from gridgcn_torch.utils import jaxrng, profiling
from gridgcn_torch.utils.profiling import annotate

torch.set_num_threads(1)
LOG = []            # the stand-in's "device": what ran, in order


def work(tag):
    """One stand-in kernel: logged, and a CPU op the profiler sees."""
    LOG.append(tag)
    torch.ones(1).add_(1)


class StandInGraph:
    """A graph that captures the stand-in kernels run between begin() and
    end() and replays them."""

    def __init__(self, kit):
        self.kit = kit
        self.tags = None

    def begin(self):
        self.start = len(LOG)

    def end(self) -> bool:
        self.tags = LOG[self.start:]
        del LOG[self.start:]            # a capture runs nothing
        self.kit.ended += 1
        return bool(self.tags)

    def replay(self):
        for t in self.tags:
            work(t)


class StandIn:
    """The stand-in kit: `CudaGraphs`'s interface without a card."""

    def __init__(self):
        self.ended = 0

    def new(self):
        return StandInGraph(self)

    def capturing(self):
        return contextlib.nullcontext()


def forward():
    """A forward with nested spans, work between them, an empty span and
    two sibling spans of one name."""
    work("pre")
    with annotate("gridconv0"):
        work("a")
        with annotate("sample"):
            with annotate("jaxrng"):
                work("draw1")
            with annotate("jaxrng"):
                work("draw2")
        with annotate("empty"):
            pass
        work("b")
    with annotate("head"):
        work("c")
    return "out"


def test_segments_in_span_order_with_their_paths():
    LOG.clear()
    kit = StandIn()
    plan = graphs.capture(forward, kit)
    assert LOG == [] and plan.output == "out"
    assert [(s.path, s.graph.tags) for s in plan.segments] == [
        ((), ["pre"]),
        (("gridconv0",), ["a"]),
        (("gridconv0", "sample", "jaxrng"), ["draw1"]),
        (("gridconv0", "sample", "jaxrng"), ["draw2"]),
        (("gridconv0",), ["b"]),
        (("head",), ["c"])]
    # two cuts a span (6 spans) and the last segment; the empty ones
    # (around `sample`'s draws, the `empty` span, between spans) dropped
    assert kit.ended == 2 * 6 + 1
    # the two draws are two entries of `jaxrng`, not one
    assert plan.segments[2].spans != plan.segments[3].spans
    plan.replay()
    assert LOG == ["pre", "a", "draw1", "draw2", "b", "c"]


def span_tree(path) -> list:
    """The trace's `gridgcn/` spans as nested (name, [children])."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith(profiling.SPAN_PREFIX)),
                   key=lambda e: (e["ts"], -e["dur"]))
    roots, stack = [], []
    for e in spans:
        while stack and stack[-1][0]["ts"] + stack[-1][0]["dur"] <= e["ts"]:
            stack.pop()
        node = (e["name"][len(profiling.SPAN_PREFIX):], [])
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((e, node))
    return roots


def test_replay_opens_the_eager_spans(tmp_path):
    """Under the CPU profiler the replay opens the spans of the eager run,
    nested alike, but for the span that held no work."""
    LOG.clear()
    plan = graphs.capture(forward, StandIn())
    with profiling.trace(str(tmp_path / "eager")):
        forward()
    with profiling.trace(str(tmp_path / "replay")):
        plan.replay()
    eager = span_tree(tmp_path / "eager" / "trace.json")
    replay = span_tree(tmp_path / "replay" / "trace.json")
    want = [("gridconv0", [("sample", [("jaxrng", []), ("jaxrng", [])]),
                           ("empty", [])]),
            ("head", [])]
    assert eager == want
    assert replay == [("gridconv0", [("sample", [("jaxrng", []),
                                                 ("jaxrng", [])])]),
                      ("head", [])]
    assert LOG == ["pre", "a", "draw1", "draw2", "b", "c"] * 2
    # nothing of a replay opens a span without a profiler
    assert profiling.annotate("x") is profiling.annotate("y")


def test_a_failed_capture_leaves_no_cutter():
    def broken():
        with annotate("gridconv0"):
            work("a")
            raise ValueError("capture hazard")

    with pytest.raises(ValueError, match="capture hazard"):
        graphs.capture(broken, StandIn())
    assert profiling._cutter is None
    LOG.clear()


def test_capture_on_second_call_and_lru_cap():
    LOG.clear()
    kits = []

    def new_kit():
        kits.append(StandIn())
        return kits[-1]

    sigs = graphs.Signatures(new_kit)
    made, eager = [], []

    def call(sig):
        if not sigs.seen(sig):          # the caller's eager forward
            eager.append(sig)
            return forward()
        static = sigs.static(sig, lambda: made.append(sig) or [sig])
        assert static == [sig]
        return sigs.run(sig, forward)

    assert call("a") == "out" and len(LOG) == 6       # eager
    assert (sigs.captures, sigs.replays, len(kits)) == (0, 0, 0)
    assert eager == ["a"] and made == [] and "a" in sigs
    call("a")                                         # captured, replayed
    assert (sigs.captures, sigs.replays, len(kits)) == (1, 0, 1)
    for _ in range(3):
        call("a")
    assert (sigs.captures, sigs.replays) == (1, 3)
    assert len(LOG) == 6 * 5 and made == ["a"] and eager == ["a"]

    cap = graphs.MAX_SIGNATURES
    for s in range(cap):                 # "a" is the least recently used
        call(s)
        call(s)
    assert len(sigs) == cap and "a" not in sigs
    assert sigs.captures == 1 + cap
    call("a")                            # eager again, nothing made
    assert eager.count("a") == 2 and made.count("a") == 1
    assert sigs.captures == 1 + cap
    assert 0 not in sigs and len(sigs) == cap
    call("a")                            # made again and captured
    assert made.count("a") == 2 and sigs.captures == 2 + cap
    assert sigs.replays == 3


def _small(cfg, centers: int, widths: int):
    """cfg with each layer's centers and every MLP width divided, the
    samplers, grids and decoder methods kept."""
    m = cfg.model
    layers = tuple(dataclasses.replace(
        l, n_centers=l.n_centers // centers,
        mlp=tuple(c // widths for c in l.mlp),
        context_channels=l.context_channels // widths) for l in m.layers)
    ups = tuple(dataclasses.replace(u, mlp=tuple(c // widths for c in u.mlp))
                for u in m.up_layers)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, layers=layers, up_layers=ups,
        head=tuple(c // widths for c in m.head)))


@pytest.mark.parametrize("name,B,N,centers,widths", [
    ("scannet_whole_scene", 1, 2048, 16, 8),
    ("scannet_seg", 2, 1024, 8, 8),
    ("modelnet40_cas", 2, 1024, 1, 4)])
def test_tensor_key_forward_equals_numpy_key(name, B, N, centers, widths,
                                             monkeypatch):
    """The forward that a capture runs (the key an int64 tensor, every
    derivation on the device) gives the numpy-key forward's CAGQ indices
    bit for bit and its logits exactly."""
    from gridgcn_torch.models.fold import fold_inference
    from gridgcn_torch.models.build import build_model

    cfg = _small(presets.get(name), centers, widths)
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    cfg, folded = fold_inference(cfg, sd)
    model = build_model(cfg.model)
    model.load_state_dict(folded)
    model.eval()
    xyz = torch.as_tensor(np.random.default_rng(1).uniform(
        0, 3, (B, N, 3)), dtype=torch.float32)
    mask = torch.ones((B, N), dtype=torch.bool)
    key = jaxrng.fold_in(jaxrng.PRNGKey(5), 2)

    groups = []
    real = gridconv.cagq

    def recording(*args, **kw):
        out = real(*args, **kw)
        groups.append(out.groups)
        return out

    monkeypatch.setattr(gridconv, "cagq", recording)
    with torch.no_grad():
        a = model(xyz, None, mask, key)
        b = model(xyz, None, mask, jaxrng.key_tensor(key))
    L = len(cfg.model.layers)
    assert len(groups) == 2 * L
    for ga, gb in zip(groups[:L], groups[L:]):
        for f in dataclasses.fields(ga):
            x, y = getattr(ga, f.name), getattr(gb, f.name)
            assert (x is None) == (y is None), f.name
            if x is not None:
                assert x.dtype == y.dtype and torch.equal(x, y), f.name
    assert a.dtype == torch.float32 and torch.equal(a, b)


HASH_OPS = ("aten::bitwise_xor", "aten::bitwise_or", "aten::__lshift__",
            "aten::__rshift__", "aten::bitwise_left_shift",
            "aten::bitwise_right_shift")


def _spans_and_ops(path):
    """The trace's `gridgcn/` spans, and for each host op its name and the
    names of the spans around it."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith(profiling.SPAN_PREFIX)]
    ops = [(e["name"], [s["name"][len(profiling.SPAN_PREFIX):]
                        for s in spans if s["ts"] <= e["ts"]
                        and e["ts"] + e["dur"] <= s["ts"] + s["dur"]])
           for e in events if e.get("cat") == "cpu_op"]
    return [e["name"][len(profiling.SPAN_PREFIX):] for e in spans], ops


@pytest.mark.parametrize("name,B,N,centers,widths", [
    ("scannet_whole_scene", 1, 2048, 16, 8),
    ("modelnet40_cas", 2, 1024, 1, 4)])
def test_tensor_key_hashes_run_inside_the_layers_spans(name, B, N, centers,
                                                       widths, tmp_path):
    """A tensor key's hashes open no span (a capture is cut at none of
    them) and run inside the span of the layer that derives the key: the
    tensor-key forward has the numpy-key forward's spans, and each of its
    hash rounds' int64 ops lies inside a `gridconv{i}` or `up{i}` span."""
    from gridgcn_torch.models.build import build_model
    from gridgcn_torch.models.fold import fold_inference

    cfg = _small(presets.get(name), centers, widths)
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    cfg, folded = fold_inference(cfg, sd)
    model = build_model(cfg.model)
    model.load_state_dict(folded)
    model.eval()
    xyz = torch.as_tensor(np.random.default_rng(2).uniform(
        0, 3, (B, N, 3)), dtype=torch.float32)
    mask = torch.ones((B, N), dtype=torch.bool)
    key = jaxrng.fold_in(jaxrng.PRNGKey(5), 2)
    seen = {}
    for kind, k in (("numpy", key), ("tensor", jaxrng.key_tensor(key))):
        with torch.no_grad(), profiling.trace(str(tmp_path / kind)):
            model(xyz, None, mask, k)
        seen[kind] = _spans_and_ops(tmp_path / kind / "trace.json")
    (numpy_spans, _), (tensor_spans, ops) = seen["numpy"], seen["tensor"]
    assert sorted(tensor_spans) == sorted(numpy_spans)
    hashes = [around for op, around in ops if op in HASH_OPS
              and "jaxrng" not in around]
    assert hashes, "no hash round outside the draws"
    layer = re.compile(r"(gridconv|up)\d+")
    assert all(any(layer.fullmatch(n) for n in around) for around in hashes)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cpu_and_mesh_predictors_never_replay():
    """The CPU Predictor and a mesh Predictor (one gloo rank in this
    process) stay eager: no capture, no replay, the same logits."""
    import torch.distributed as dist

    cfg = presets.get("synthetic_tiny_seg")
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    xyz = np.random.default_rng(0).uniform(0, 4, (2, 256, 3)).astype(
        np.float32)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        preds = (Predictor(cfg, sd, device="cpu"),
                 Predictor(cfg, sd, device="cpu", mesh=1))
        outs = [[p(xyz) for _ in range(3)] for p in preds]
    finally:
        dist.destroy_process_group()
    for pred in preds:
        assert pred.requests == 3
        assert (pred.captures, pred.replays) == (0, 0)
        assert pred._graphs is None
    for o in outs[0][1:] + outs[1]:
        np.testing.assert_array_equal(o, outs[0][0])
