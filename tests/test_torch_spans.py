"""The program's spans (`utils.profiling.annotate`) on a tiny served
request of the segmentation network and on a small one of the
`modelnet40_cas` classifier: under `torch.profiler` each `Predictor` call
is one span `gridgcn/request#<n>` (n: the call's number, which the Chrome
trace keeps in the span's name; it drops `record_function`'s args),
holding the layers' spans in the order the request runs them; with no
profiler recording the helper enters no `record_function`; the profiler
changes no logit."""

import json

import numpy as np
import pytest
import torch

from gridgcn_torch.api import Predictor
from gridgcn_torch.configs import presets
from gridgcn_torch.models.build import init_model
from gridgcn_torch.utils import profiling

torch.set_num_threads(1)
PREFIX = profiling.SPAN_PREFIX


@pytest.fixture(scope="module")
def served():
    """A tiny segmentation Predictor on the CPU and a request of 2 clouds."""
    cfg = presets.synthetic_tiny_seg()
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    xyz = np.random.default_rng(0).uniform(-1, 1, (2, 1024, 3)).astype(
        np.float32)
    return cfg, Predictor(cfg, sd, device="cpu"), xyz


@pytest.fixture(scope="module")
def classifier():
    """The `modelnet40_cas` classifier served on the CPU (CAS in all three
    layers, bf16 with BatchNorm folded) and a request of 2 clouds of 1024
    points."""
    cfg = presets.modelnet40_cas()
    _, sd = init_model(cfg.model, torch.Generator().manual_seed(1))
    xyz = np.random.default_rng(1).uniform(-1, 1, (2, 1024, 3)).astype(
        np.float32)
    return cfg, Predictor(cfg, sd, device="cpu"), xyz


def span_tree(path) -> list:
    """The trace's `gridgcn/` spans as [(name, [children])], nested by
    containment on each thread, in start order."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith(PREFIX)),
                   key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    roots, stack = [], []
    for e in spans:
        while stack and (stack[-1][0]["tid"] != e["tid"] or
                         stack[-1][0]["ts"] + stack[-1][0]["dur"]
                         <= e["ts"]):
            stack.pop()
        node = (e["name"][len(PREFIX):], [])
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((e, node))
    return roots


def names(nodes) -> list:
    return [n for n, _ in nodes]


def descendants(node) -> list:
    return [d for c in node[1] for d in [c[0]] + descendants(c)]


def check_layers(kids: dict, L: int):
    """Each encoder layer's span holds CAGQ's three steps, then `group`
    and `gca`."""
    for i in range(L):
        layer = kids[f"gridconv{i}"]
        assert names(layer) == ["voxelize", "sample", "gather", "group",
                                "gca"]
        # the draws are spans of their own inside CAGQ's steps, never
        # one per hash round
        cagq = [d for n, c in layer[:3] for d in descendants((n, c))]
        assert "jaxrng" in cagq and set(cagq) == {"jaxrng"}
        assert all(not c for _, c in layer[3:])


def test_request_span_tree(served, tmp_path):
    cfg, predict, xyz = served
    plain = predict(xyz)
    first = predict.requests
    with profiling.trace(str(tmp_path)):
        traced = [predict(xyz), predict(xyz)]
    # the profiler changes no logit
    for out in traced:
        np.testing.assert_array_equal(out, plain)

    L = len(cfg.model.layers)
    tree = span_tree(tmp_path / "trace.json")
    assert names(tree) == [f"request#{first}", f"request#{first + 1}"]
    for req in tree:
        assert names(req[1]) == (
            ["copy_in"] + [f"gridconv{i}" for i in range(L)]
            + [f"up{i}" for i in range(L)] + ["head", "fetch"])
        kids = dict(req[1])
        check_layers(kids, L)
        for i in range(L):
            assert names(kids[f"up{i}"]) == ["knn3"]
        assert not kids["copy_in"] and not kids["fetch"]


def test_no_record_function_without_a_profiler(served, monkeypatch,
                                               tmp_path):
    _, predict, xyz = served
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not torch.autograd._profiler_enabled()
    predict(xyz)
    assert entered == [] and profiling.annotate("x") is \
        profiling.annotate("y")
    with profiling.trace(str(tmp_path)):
        predict(xyz)
    assert entered[0].startswith(PREFIX + "request#")
    assert {PREFIX + "gridconv0", PREFIX + "fetch"} <= set(entered)


def test_classifier_request_span_tree(classifier, tmp_path):
    """A classifier request: `copy_in`, each stage's `gridconv{i}`, then
    `head` (the pool, the head MLP and the logits) and `fetch`."""
    cfg, predict, xyz = classifier
    plain = predict(xyz)
    first = predict.requests
    with profiling.trace(str(tmp_path)):
        traced = predict(xyz)
    np.testing.assert_array_equal(traced, plain)
    assert plain.shape == (2, cfg.model.num_classes)

    L = len(cfg.model.layers)
    assert L == 3 and {s.sampler for s in cfg.model.layers} == {"cas"}
    tree = span_tree(tmp_path / "trace.json")
    assert names(tree) == [f"request#{first}"]
    req = tree[0]
    assert names(req[1]) == (["copy_in"] + [f"gridconv{i}" for i in range(L)]
                             + ["head", "fetch"])
    kids = dict(req[1])
    check_layers(kids, L)
    assert not kids["copy_in"] and not kids["head"] and not kids["fetch"]


def test_classifier_no_record_function_without_a_profiler(
        classifier, monkeypatch):
    _, predict, xyz = classifier
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not torch.autograd._profiler_enabled()
    predict(xyz)
    assert entered == []
