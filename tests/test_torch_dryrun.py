"""The port's multi-device dry run (`gridgcn_torch.dryrun`), the
counterpart of `__graft_entry__.dryrun_multichip`: every part at two
ranks in one spawned gloo group on the CPU."""

import json

import numpy as np
import pytest

from gridgcn_torch import dryrun


def test_dryrun_two_ranks_on_the_cpu():
    """Parts 1–5 and 7 run (part 6 needs four ranks); the printed lines
    keep the reference's formats: one FEATURED_SPATIAL_TRAIN line with
    calibrated caps and no overflow, and six COMM_REPORT lines (both
    presets at the default, calibrated and quarter-share caps) with byte
    fields and no projection (no measured anchors were given)."""
    out = dryrun.dryrun_multichip(2, device="cpu", timeout_s=300)
    assert np.isfinite(out["dp_loss"]) and np.isfinite(out["spatial_loss"])
    kinds = [line.split(" ", 1)[0] for line in out["lines"]]
    assert kinds == ["FEATURED_SPATIAL_TRAIN"] + ["COMM_REPORT"] * 6
    rec = json.loads(out["lines"][0].split(" ", 1)[1])
    assert rec["config"] == "s3dis_seg" and rec["tier"] == 3
    assert rec["n_devices"] == 2 and rec["ghost_overflow"] == 0
    assert len(rec["ghost_cap"]) == 4 and np.isfinite(rec["loss"])
    reps = [json.loads(line.split(" ", 1)[1]) for line in out["lines"][1:]]
    assert [r["ghost_cap_setting"] for r in reps] == [
        f"{p}:{c}" for p in ("scannet_seg", "scannet_whole_scene")
        for c in ("default", "calibrated", "quarter_share")]
    for r in reps:
        assert r["n_devices"] == 2 and "projection" not in r
        assert r["tier2"]["bytes_per_chip"] > 0
        assert r["tier3"]["bytes_per_dir_per_chip"] > 0


def test_dryrun_refuses_a_missing_card():
    """No fallback: without a card the default device raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.rank_devices(2)
