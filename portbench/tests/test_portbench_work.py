"""The work counts against hand-worked numbers."""

import pytest

from work.dense_flops import _mlp, forward_flops
from work.knn3_bytes import knn3_bytes
from work.knn3_pairs import knn3_pairs
from work.levels import decoder_calls


def _cfg():
    """One encoder layer (8 centers of 16 points, 4 neighbours, widths
    xyz → 6) and one decoder stage back to the 16 points."""
    layer = {"n_centers": 8, "k_neighbors": 4, "mlp": [6],
             "use_coverage": True, "use_context_pool": True,
             "context_channels": 2, "att_hidden": 5, "pool": "max"}
    return {"data": {"num_points": 16},
            "model": {"task": "seg", "in_channels": 0,
                      "use_xyz_feature": True,
                      "layers": [layer], "num_classes": 3, "head": [7],
                      "up_layers": [{"mlp": [9], "k_interp": 3,
                                     "method": "pallas"}]}}


def test_one_dense():
    # 10 rows of a 3 → 5 Dense: 10 · 3 · 5 multiply-adds
    assert _mlp(10, 3, [5]) == (300, 5)


def test_forward_by_hand():
    B = 2
    edge = 2 * (B * 8 * 4) * (3 + 4) * 6          # rows B·M·K, 7 → 6
    ctx = 2 * (B * 8) * (3 + 4) * 2               # rows B·M, 7 → 2
    att = 2 * (B * 8 * 4) * (4 + 2 + 2) * 5 + 2 * (B * 8 * 4) * 5 * 1
    dec = 2 * (B * 16) * (6 + 3) * 9              # 16 queries, 6 + xyz → 9
    head = 2 * (B * 16) * 9 * 7 + 2 * (B * 16) * 7 * 3
    assert forward_flops(_cfg(), B) == edge + ctx + att + dec + head


def test_forward_with_features_by_hand():
    """Two input channels beside xyz widen the first layer's edge and
    context inputs (7 → 9) and the last decoder stage's skip (6 + 5)."""
    cfg = _cfg()
    cfg["model"]["in_channels"] = 2
    B = 2
    edge = 2 * (B * 8 * 4) * (5 + 4) * 6
    ctx = 2 * (B * 8) * (5 + 4) * 2
    att = 2 * (B * 8 * 4) * (4 + 2 + 2) * 5 + 2 * (B * 8 * 4) * 5 * 1
    dec = 2 * (B * 16) * (6 + 5) * 9
    head = 2 * (B * 16) * 9 * 7 + 2 * (B * 16) * 7 * 3
    assert forward_flops(cfg, B) == edge + ctx + att + dec + head


def test_classifier_by_hand():
    """A classifier: the same encoder, no decoder, the head and logits on
    each cloud's one pooled row."""
    cfg = _cfg()
    cfg["model"]["task"] = "cls"
    B = 2
    edge = 2 * (B * 8 * 4) * (3 + 4) * 6
    ctx = 2 * (B * 8) * (3 + 4) * 2
    att = 2 * (B * 8 * 4) * (4 + 2 + 2) * 5 + 2 * (B * 8 * 4) * 5 * 1
    head = 2 * B * 6 * 7 + 2 * B * 7 * 3             # 6 → 7 → 3 classes
    assert forward_flops(cfg, B) == edge + ctx + att + head
    assert decoder_calls(cfg) == []
    assert knn3_bytes(cfg, B) == 0 and knn3_pairs(cfg, B) == 0
    cfg["model"]["task"] = "seg"
    cfg["model"]["up_layers"] = []
    assert decoder_calls(cfg) == [] and knn3_bytes(cfg, B) == 0


def test_one_decoder_call():
    cfg = _cfg()
    assert decoder_calls(cfg) == [(16, 8, 3, "pallas")]
    # read: (16 + 8) points × (12 B xyz + 1 B mask); write: 16 × 3 × 8 B
    assert knn3_bytes(cfg, 1) == 24 * 13 + 16 * 3 * 8
    assert knn3_bytes(cfg, 2) == 2 * (24 * 13 + 16 * 3 * 8)
    assert knn3_pairs(cfg, 2) == 2 * 16 * 8


def test_other_methods_are_not_the_kernel_path():
    cfg = _cfg()
    cfg["model"]["up_layers"][0]["method"] = "dense"
    assert knn3_bytes(cfg, 1) == 0 and knn3_pairs(cfg, 1) == 0


@pytest.mark.parametrize("preset,batch,gflop,mbytes", [
    ("scannet_whole_scene", 1, 25.164578816, 3.570304),
    ("scannet_seg", 8, 36.840275968, 3.50336)])
def test_presets(preset, batch, gflop, mbytes):
    from gridgcn_torch.configs import base, presets

    cfg = base.to_dict(presets.get(preset))
    assert forward_flops(cfg, batch) == round(gflop * 1e9)
    assert knn3_bytes(cfg, batch) == round(mbytes * 1e6)
