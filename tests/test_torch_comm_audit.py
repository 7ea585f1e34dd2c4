"""The port's communication audit (`gridgcn_torch.parallel.comm_audit`):
its byte counts against the bytes the port's collectives are handed in a
world-2 gloo run on the CPU (`tests/torch_comm_worker.py`, which wraps
torch.distributed's calls; the program has no counter of its own), and
against the JAX package's `comm_report` for the same config and mesh size,
but for the differences ROADMAP §3 lists."""

import numpy as np
import pytest
import torch

from gridgcn_tpu.configs import presets as jpresets
from gridgcn_tpu.parallel import comm_audit as jaudit
from gridgcn_torch.configs import presets as tpresets
from gridgcn_torch.parallel import comm_audit as audit
from gridgcn_torch.parallel import mesh as pmesh
from gridgcn_torch.parallel.launch import launch
from gridgcn_torch.utils import hw
from tests import torch_comm_worker as worker

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """{program: [rank 0's, rank 1's] [(collective, bytes), ...]}."""
    tmp = tmp_path_factory.mktemp("comm")
    launch(worker.run_all, pmesh.mesh_devices("cpu", 2), str(tmp),
           timeout_s=300)
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
    return {k: [r[k] for r in ranks] for k in ranks[0]}


def _sum(log, *kinds):
    return sum(b for k, b in log if k in kinds)


@pytest.mark.parametrize("task", ["cls", "seg"])
def test_dp_step_bytes_equal_the_audit(counted, task):
    """A DP train step: every byte handed to an all-reduce (gradients,
    both BatchNorm all-reduces, the loss's counts) is the audit's payload,
    on both ranks; the gradients are one all-reduce of param_bytes."""
    rep = audit.comm_report(worker.config(worker.DP_CASES[task]), 2)
    for log in counted[f"dp {task}"]:
        assert {k for k, _ in log} == {"all_reduce"}
        assert _sum(log, "all_reduce") == rep["dp"]["payload_bytes"]
        assert max(b for _, b in log) == rep["param_bytes"]
    assert rep["dp"]["allreduce_bytes"] == rep["dp"]["payload_bytes"]


def test_tier_forward_bytes_equal_the_audit(counted):
    """Tier 2's forward: three all-gathers (xyz, features, valid) of the
    rank's M₁/D rows; tier 3's: each rank sends the per-direction bytes
    of every level's exchange and refresh one way (a ring of two), and
    receives as many."""
    cfg = worker.config(worker.TIER_CASE)
    rep = audit.comm_report(cfg, 2)
    for log in counted["tier2"]:
        assert [k for k, _ in log] == ["all_gather"] * 3
        assert _sum(log, "all_gather") == rep["tier2"]["payload_bytes"]
    assert rep["tier2"]["payload_bytes"] * 2 == \
        rep["tier2"]["all_gather_rows"] * rep["tier2"]["row_bytes"]
    for log in counted["tier3"]:
        assert {k for k, _ in log} == {"isend", "irecv"}
        assert _sum(log, "isend") == _sum(log, "irecv") == \
            rep["tier3"]["bytes_per_dir_per_chip"]


@pytest.mark.parametrize("tier", ["resident", "resident_ml"])
def test_spatial_train_step_bytes_equal_the_audit(counted, tier):
    """A spatial train step adds what the audit's train fields count: the
    backward's all-reduce of the gathered cotangent (tier 2) or its
    reverse shifts (tier 3), the running statistics' ring mean, the
    gradients and the counts."""
    rep = audit.comm_report(worker.config(worker.TIER_CASE), 2)
    for log in counted[f"train {tier}"]:
        if tier == "resident":
            assert _sum(log, "all_gather") == rep["tier2"]["payload_bytes"]
            assert _sum(log, "all_reduce") == \
                rep["tier2"]["train_allreduce_payload_bytes"]
        else:
            assert _sum(log, "isend") == _sum(log, "irecv") == \
                rep["tier3"]["train_bytes_per_dir_per_chip"]
            assert _sum(log, "all_reduce") == \
                rep["tier3"]["train_allreduce_payload_bytes"]


def _batch_stat_bytes(cfg_j) -> int:
    """The bytes of the BatchNorm running statistics in JAX's variables."""
    import jax

    from gridgcn_tpu.models.build import build_model

    B, N = 2, max(cfg_j.data.num_points, 64)
    shapes = jax.eval_shape(lambda: build_model(cfg_j.model).init(
        {"params": jax.random.PRNGKey(0), "cagq": jax.random.PRNGKey(1)},
        jax.numpy.zeros((B, N, 3)), None, jax.numpy.ones((B, N), bool),
        False))
    return int(sum(np.prod(x.shape) * x.dtype.itemsize for x in
                   jax.tree_util.tree_leaves(shapes["batch_stats"])))


@pytest.mark.parametrize("name,D,caps", [
    ("synthetic_tiny_seg", 2, 0),
    ("scannet_whole_scene", 8, (64, 32, 8, 8))])
def test_byte_fields_agree_with_jax(name, D, caps):
    """The byte fields both audits have agree, but for ROADMAP §3's
    differences: the port's param_bytes are JAX's less the BatchNorm
    running statistics (no gradient flows to them), so its gradient
    all-reduce is that much smaller."""
    cfg_j, cfg_t = jpresets.get(name), tpresets.get(name)
    j = jaudit.comm_report(cfg_j, D, ghost_cap=caps)
    t = audit.comm_report(cfg_t, D, ghost_cap=caps)
    assert t["param_bytes"] == j["param_bytes"] - _batch_stat_bytes(cfg_j)
    assert t["dp"]["grad_psum_bytes"] == int(
        2 * (D - 1) / D * t["param_bytes"])
    for f in ("all_gather_rows", "row_bytes", "bytes_per_chip"):
        assert t["tier2"][f] == j["tier2"][f], f
    assert t["tier3"]["bytes_per_dir_per_chip"] == \
        j["tier3"]["bytes_per_dir_per_chip"]
    for lt, lj in zip(t["tier3"]["levels"], j["tier3"]["levels"]):
        for f in ("level", "H", "enc_bytes_per_dir", "refresh_bytes_per_dir"):
            assert lt[f] == lj[f], (f, lt, lj)


def test_projection_takes_measured_anchors_only():
    """No measurement is built in: the projection needs the caller's
    compute time, ghost tax and decoder kNN times, uses the published
    NVLink rate, and says it is a projection."""
    cfg = tpresets.scannet_whole_scene()
    knn_ms = [0.01, 0.02, 0.05, 0.3]
    rep = audit.comm_report(cfg, 4)
    assert "projection" not in rep and rep["tier2"]["replicated_frac"] is None
    with pytest.raises(ValueError, match="ghost tax"):
        audit.comm_report(cfg, 4, compute_ms_per_step=10.0)
    with pytest.raises(ValueError, match="kNN"):
        audit.comm_report(cfg, 4, compute_ms_per_step=10.0, ghost_tax=0.5)
    rep = audit.comm_report(cfg, 4, compute_ms_per_step=10.0, ghost_tax=0.5,
                            knn_ms=knn_ms)
    p = rep["projection"]
    assert "projection" in p["basis"] and 0 < p["tier3_inference_efficiency"]
    assert p["tier3_inference_efficiency"] < 1 / 1.5
    assert p["tier3_train_efficiency"] < 1 / 1.5
    assert rep["tier3"]["time_ms"] == pytest.approx(
        rep["tier3"]["bytes_per_dir_per_chip"] / hw.NVLINK_BYTES_PER_S * 1e3)
    assert not [k for k in vars(audit) if k.startswith(("MEASURED", "V5E"))]
    assert not [k for k in vars(hw) if "V5E" in k or "ICI" in k]


def test_tier2_split_prices_the_measured_knn():
    """Tier 2's replicated share charges each decoder stage's kNN at the
    caller's measured ms: the coarse stages' time joins the replicated
    share, the last stage's the sharded one; a list that does not have
    one time per stage is refused."""
    cfg = tpresets.scannet_whole_scene()
    dense, repl = audit._tier2_stage_ms(cfg, [0.0] * 4)
    d2, r2 = audit._tier2_stage_ms(cfg, [1.0, 2.0, 3.0, 0.0])
    assert r2 == pytest.approx(repl + 6.0) and d2 == pytest.approx(dense)
    d3, r3 = audit._tier2_stage_ms(cfg, [0.0, 0.0, 0.0, 5.0])
    assert d3 == pytest.approx(dense + 5.0) and r3 == pytest.approx(repl)
    assert audit.tier2_replicated_fraction(cfg, [1.0, 2.0, 3.0, 0.0]) == \
        pytest.approx(r2 / (d2 + r2))
    with pytest.raises(ValueError, match="stages"):
        audit.tier2_replicated_fraction(cfg, [1.0])
