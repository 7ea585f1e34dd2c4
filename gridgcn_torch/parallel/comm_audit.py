"""Communication audit of the port's parallel programs (the JAX package's
`parallel/comm_audit.py`).

From a config and a mesh size it counts the bytes each rank hands to the
port's collectives in one step, in the port's own row layout (xyz float32,
features in the model dtype, a bool valid flag), and projects transfer
times over NVLink:

  * the data-parallel train step (`parallel.dp`): one all-reduce of every
    parameter's gradient (float32), two all-reduces of [sum | sum of
    squares] per BatchNorm (the forward's global batch statistics and
    their backward), and the loss's scalar counts; a ring all-reduce puts
    2(D−1)/D of its payload on each rank's link;
  * tier 2 (`parallel.resident`): one all-gather of the layer-1 level, each
    rank's M₁/D rows of (xyz, feature, valid); each rank receives (D−1)/D
    of the assembled level. Training adds the gathered features'
    cotangent all-reduce, the running statistics' ring mean
    (`ring_mean_stats`), the gradients and the scalar counts;
  * tier 3 (`parallel.resident_ml`): per encoder level two ring shifts
    (one per direction) of H rows of (xyz, feature, valid)
    (`exchange_boundary`), and per ghost-carrying decoder stage two of H
    rows of the updated features (`refresh_ghosts`); the deepest level is
    never refreshed. An interior rank sends the per-direction bytes each
    way, a ring end one way. Training adds the shifts' backward (the
    features' cotangents, the reverse shift) and what tier 2's adds.

`tests/test_torch_comm_audit.py` holds every byte count against the bytes
the collectives are handed in a world-2 run, and against the JAX package's
arithmetic, whose differences ROADMAP §3 lists. No measurement is built
in: the projection takes the per-shard compute time, the ghost-compute
tax and the decoder's kNN times (tier 2's replicated share) as
arguments, and its transfer times are projections from the published
NVLink rate (`utils/hw.py`), not measurements.
"""

from __future__ import annotations

import json
from typing import Optional

import torch

from gridgcn_torch.configs.base import Config
from gridgcn_torch.parallel.resident_ml import ghost_caps
from gridgcn_torch.utils.hw import HBM_BYTES_PER_S, NVLINK_BYTES_PER_S

XYZ_BYTES = 3 * 4           # float32 xyz
VALID_BYTES = 1             # bool
F32 = 4
I64 = 8


def _dtype_bytes(name: str) -> int:
    return torch.empty((), dtype=getattr(torch, name)).element_size()


def _ring(D: int) -> float:
    """The share of an all-reduce's payload a ring puts on each link."""
    return 2 * (D - 1) / D


def model_bytes(cfg: Config) -> dict:
    """From the port's own modules: {"param_bytes": the trainable
    parameters' bytes (a gradient all-reduce's payload), "bn_features":
    each BatchNorm's feature count}."""
    from gridgcn_torch.models.build import build_model
    from gridgcn_torch.models.layers import BatchNorm

    with torch.device("meta"):
        model = build_model(cfg.model)
    return {"param_bytes": int(sum(p.numel() * p.element_size()
                                   for p in model.parameters())),
            "bn_features": [m.weight.numel() for m in model.modules()
                            if isinstance(m, BatchNorm)]}


def _tier2_stage_ms(cfg: Config, knn_ms) -> tuple:
    """(dense_ms, replicated_ms): tier 2 shards the dense stages (encoder
    layer 0, the last decoder stage, the head) and replicates the rest.
    Each decoder stage's kNN is the caller's measured time (`knn_ms`, one
    per stage, coarsest first, at the single-device shapes); the other
    work is a byte model at the card's published HBM rate. A model, for
    the split only: its absolute times are not the card's."""
    dt = _dtype_bytes(cfg.model.dtype)
    layers, ups = cfg.model.layers, cfg.model.up_layers
    N = cfg.data.num_points
    build_b = 16             # per input row of the voxel build: key, passes
    if len(knn_ms) != len(ups):
        raise ValueError(f"knn_ms has {len(knn_ms)} stages, the decoder "
                         f"{len(ups)}")

    def enc_ms(n_in, c_in, layer):
        M, K = layer.n_centers, layer.k_neighbors
        b = (n_in * build_b + M * K * (XYZ_BYTES + c_in * dt)
             + M * K * sum(layer.mlp) * dt * 2
             + M * (layer.context_channels + layer.mlp[-1]) * dt * 2)
        return b / HBM_BYTES_PER_S * 1e3

    def dec_ms(n_tgt, c_src, up, c_skip):
        b = (n_tgt * 3 * c_src * dt
             + n_tgt * (c_src + c_skip + sum(up.mlp) * 2) * dt)
        return b / HBM_BYTES_PER_S * 1e3

    c_in0 = (3 if cfg.model.use_xyz_feature else 0) + cfg.model.in_channels
    sizes = [N] + [layer.n_centers for layer in layers]
    widths = [c_in0] + [layer.mlp[-1] for layer in layers]
    dense = enc_ms(N, c_in0, layers[0])
    repl = sum(enc_ms(sizes[i], widths[i], layers[i])
               for i in range(1, len(layers)))
    for s, up in enumerate(ups):
        j = len(layers) - 1 - s
        c_src = widths[j + 1] if s == 0 else ups[s - 1].mlp[-1]
        t = knn_ms[s] + dec_ms(sizes[j], c_src, up, widths[j])
        if s == len(ups) - 1:
            dense += t
        else:
            repl += t
    head_rows = N if cfg.model.task == "seg" else cfg.data.batch_size
    dense += head_rows * (sum(cfg.model.head) + cfg.model.num_classes) \
        * dt * 2 / HBM_BYTES_PER_S * 1e3
    return dense, repl


def tier2_replicated_fraction(cfg: Config, knn_ms) -> float:
    """The share of the single-device forward that tier 2 runs on every
    rank (the replicated coarse pyramid), from `_tier2_stage_ms` with the
    decoder's measured kNN times."""
    dense, repl = _tier2_stage_ms(cfg, knn_ms)
    return repl / max(dense + repl, 1e-12)


def comm_report(cfg: Config, n_devices: int, ghost_cap=0,
                compute_ms_per_step: Optional[float] = None,
                ghost_tax: Optional[float] = None,
                knn_ms=None) -> dict:
    """Per-step bytes of every parallel program at `n_devices` ranks, and
    (with `compute_ms_per_step`, the single-device time over D, `ghost_tax`,
    tier 3's per-shard compute inflation, and `knn_ms`, the decoder's kNN
    ms per stage, coarsest first, all measured by the caller) projected
    efficiencies. `ghost_cap`: tier 3's rows per face, an int for every
    level or one per level (0: the level's share). Training is projected
    from the same compute time and ghost tax."""
    D = n_devices
    dt = _dtype_bytes(cfg.model.dtype)
    layers, ups = cfg.model.layers, cfg.model.up_layers
    caps = ghost_caps(ghost_cap, len(layers))
    mb = model_bytes(cfg)
    pbytes = mb["param_bytes"]
    bn_stats = sum(2 * c * F32 for c in mb["bn_features"])
    seg = cfg.model.task == "seg"
    # the loss's counts: seg the weight sum (f32), the point and hit counts
    # (int64) and the loss (f32); cls the cloud count, the hits, the loss
    scalars = F32 + 2 * I64 + F32 if seg else 3 * F32
    dp_payload = pbytes + 2 * bn_stats + scalars
    report = {
        "n_devices": D,
        "param_bytes": pbytes,
        "dp": {
            "grad_payload_bytes": pbytes,
            "bn_payload_bytes": 2 * bn_stats,
            "scalar_payload_bytes": scalars,
            "payload_bytes": dp_payload,
            "grad_psum_bytes": int(_ring(D) * pbytes),
            "allreduce_bytes": int(_ring(D) * dp_payload),
            "time_ms": _ring(D) * dp_payload / NVLINK_BYTES_PER_S * 1e3,
        },
    }

    # ---- tier 2: one all-gather of the layer-1 level ----
    m1, c1 = layers[0].n_centers, layers[0].mlp[-1]
    row = XYZ_BYTES + c1 * dt + VALID_BYTES
    ag_bytes = (D - 1) / D * m1 * row
    # training: the gathered features' cotangent all-reduce [m1, c1], the
    # running statistics' ring mean, the gradients, the counts (weight
    # sum, loss, hits, owned points)
    t2_train = (m1 * c1 * dt + bn_stats + pbytes + 2 * F32 + 2 * I64)
    report["tier2"] = {
        "all_gather_rows": m1,
        "row_bytes": row,
        "payload_bytes": m1 // D * row,
        "bytes_per_chip": int(ag_bytes),
        "train_allreduce_payload_bytes": t2_train,
        "time_ms": ag_bytes / NVLINK_BYTES_PER_S * 1e3,
        "replicated_frac": (None if knn_ms is None else
                            tier2_replicated_fraction(cfg, knn_ms)),
    }

    # ---- tier 3: per-level ring shifts ----
    per_level = []
    fwd_dir = bwd_dir = 0
    for i, layer in enumerate(layers):
        if layer.n_centers % D:
            raise ValueError(f"layers[{i}].n_centers % {D} != 0")
        H = caps[i] or max(8, layer.n_centers // D)
        enc = H * (XYZ_BYTES + layer.mlp[-1] * dt + VALID_BYTES)
        # decode stage s refreshes level len(layers) - 2 - s with its
        # up-MLP's width; the deepest level is never refreshed
        stage = len(layers) - 2 - i
        ref = (H * ups[stage].mlp[-1] * dt
               if i < len(layers) - 1 and 0 <= stage < len(ups) else 0)
        # the backward sends the features' cotangents the other way
        back = H * layer.mlp[-1] * dt + ref
        per_level.append({"level": i, "H": H, "enc_bytes_per_dir": enc,
                          "refresh_bytes_per_dir": ref,
                          "train_backward_bytes_per_dir": back})
        fwd_dir += enc + ref
        bwd_dir += back
    report["tier3"] = {
        "levels": per_level,
        "bytes_per_dir_per_chip": fwd_dir,
        "train_bytes_per_dir_per_chip": fwd_dir + bwd_dir,
        # the running statistics' ring mean, the gradients, the counts
        # (weight sum, loss, hits, owned points, ghost overflow)
        "train_allreduce_payload_bytes": bn_stats + pbytes + 2 * F32
        + 3 * I64,
        "time_ms": fwd_dir / NVLINK_BYTES_PER_S * 1e3,
        "ghost_compute_tax": ghost_tax,
    }

    if compute_ms_per_step is not None:
        if ghost_tax is None or knn_ms is None:
            raise ValueError("a projection needs the measured ghost tax "
                             "and the decoder's measured kNN ms")
        t3 = report["tier3"]["time_ms"]
        t3_train = (report["tier3"]["train_bytes_per_dir_per_chip"]
                    + _ring(D) * report["tier3"]
                    ["train_allreduce_payload_bytes"]) \
            / NVLINK_BYTES_PER_S * 1e3
        repl = report["tier2"]["replicated_frac"]
        t2_shard = ((1 - repl) * compute_ms_per_step
                    + repl * compute_ms_per_step * D
                    + report["tier2"]["time_ms"])
        report["projection"] = {
            "basis": f"NVLink {NVLINK_BYTES_PER_S:.3g} B/s per direction "
                     f"(published); a projection, not a measurement",
            "compute_ms_per_shard": compute_ms_per_step,
            "tier3_inference_efficiency":
                compute_ms_per_step / (compute_ms_per_step * (1 + ghost_tax)
                                       + t3),
            "tier3_train_efficiency":
                compute_ms_per_step / (compute_ms_per_step * (1 + ghost_tax)
                                       + t3_train),
            "tier2_inference_efficiency": compute_ms_per_step / t2_shard,
        }
    return report


def print_comm_report(cfg: Config, n_devices: int,
                      compute_ms_per_step: Optional[float] = None,
                      ghost_cap=0,
                      label: Optional[str] = None,
                      ghost_tax: Optional[float] = None,
                      knn_ms=None) -> dict:
    """`comm_report` printed as one `COMM_REPORT {json}` line."""
    rep = comm_report(cfg, n_devices, ghost_cap=ghost_cap,
                      compute_ms_per_step=compute_ms_per_step,
                      ghost_tax=ghost_tax, knn_ms=knn_ms)
    if label is not None:
        rep = {"ghost_cap_setting": label, **rep}
    print("COMM_REPORT " + json.dumps(rep))
    return rep
