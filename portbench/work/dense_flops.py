"""The dense layers' floating-point operations of one forward pass: every
Dense of each GCA (edge MLP, attention MLP and context projection), at
every one of the K neighbour slots (the dense work runs on all of them,
masked or not), then by the configuration's task: for segmentation
(`"seg"`) each decoder stage's MLP and the head and logits on every input
point, for classification (`"cls"`) no decoder and the head and logits on
each cloud's one pooled row. 2 operations a multiply-add. Biases,
activations and pooling are left out."""

from __future__ import annotations

from work.levels import point_counts, widths


def _mlp(rows: int, c: int, outs) -> tuple:
    ops = 0
    for w in outs:
        ops += 2 * rows * c * int(w)
        c = int(w)
    return ops, c


def forward_flops(cfg: dict, batch: int) -> int:
    """Operations of one forward pass over `batch` clouds."""
    m = cfg["model"]
    n, w = point_counts(cfg), widths(cfg)
    ops = 0
    for i, layer in enumerate(m["layers"]):
        M, K = int(layer["n_centers"]), int(layer["k_neighbors"])
        rows = batch * M * K
        edge, _ = _mlp(rows, w[i] + 4, layer["mlp"])
        ops += edge
        att_in = 4 + (2 if layer.get("use_coverage", True) else 0)
        if layer.get("use_context_pool", True):
            ctx_in = (w[i] if layer.get("context_pool_source") ==
                      "candidates" and w[i] else w[i] + 4)
            ops += 2 * batch * M * ctx_in * int(layer["context_channels"])
            att_in += int(layer["context_channels"])
        att, _ = _mlp(rows, att_in, [layer.get("att_hidden", 16), 1])
        ops += att
        if layer.get("pool", "max") == "maxsum":
            c = int(layer["mlp"][-1])
            ops += 2 * batch * M * 2 * c * c
    c = w[-1]
    if m.get("task", "cls") == "cls":            # the global max-pool
        head, c = _mlp(batch, c, m["head"])
        return ops + head + 2 * batch * c * int(m["num_classes"])
    L = len(m["layers"])
    for i, up in enumerate(m["up_layers"]):
        q = n[L - 1 - i]
        c += w[L - 1 - i] or 3
        dec, c = _mlp(batch * q, c, up["mlp"])
        ops += dec
    head, c = _mlp(batch * n[0], c, m["head"])
    return ops + head + 2 * batch * n[0] * c * int(m["num_classes"])
