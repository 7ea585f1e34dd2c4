"""Weights carried across: flax variables ⇄ the port's state_dict.

`convert_flax_variables` takes the JAX package's unfolded variables as
numpy nested dicts ({"params": ..., "batch_stats": ...}) and returns a
state_dict whose keys are the flax module paths joined with dots:

  Dense      {kernel [in, out], bias}  → {weight [out, in], bias}
  BatchNorm  {scale, bias} + stats {mean, var}
             → {weight, bias, running_mean, running_var}

e.g. params/gridconv0/gca/edge_dense0/kernel → gridconv0.gca.edge_dense0.
weight. Flax's BatchNorm momentum 0.9 is torch's 0.1 and both use eps 1e-5;
the port's own `models.fold.fold_inference` folds the result.
`state_dict_to_flax` is the reverse: a state_dict (a trained one, say) as
flax's {"params", "batch_stats"} numpy trees.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def convert_flax_variables(variables: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    state = {}

    def walk(params, stats, prefix):
        for name, val in params.items():
            path = prefix + name
            if "kernel" in val:
                state[path + ".weight"] = _tensor(val["kernel"]).T.contiguous()
                if "bias" in val:
                    state[path + ".bias"] = _tensor(val["bias"])
            elif "scale" in val:
                state[path + ".weight"] = _tensor(val["scale"])
                state[path + ".bias"] = _tensor(val["bias"])
                state[path + ".running_mean"] = _tensor(stats[name]["mean"])
                state[path + ".running_var"] = _tensor(stats[name]["var"])
            else:
                walk(val, stats.get(name, {}), path + ".")

    walk(variables["params"], variables.get("batch_stats", {}), "")
    return state


def state_dict_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state_dict as flax variables: {"params": ...,
    "batch_stats": ...} nested dicts of float32 numpy arrays, Dense
    weights transposed back to [in, out] kernels."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, path, leaf, value):
        for name in path:
            tree = tree.setdefault(name, {})
        tree[leaf] = value.detach().cpu().numpy().astype(np.float32)

    for key, value in state.items():
        *path, leaf = key.split(".")
        if f"{'.'.join(path)}.running_mean" in state:        # BatchNorm
            if leaf == "weight":
                put(params, path, "scale", value)
            elif leaf == "bias":
                put(params, path, "bias", value)
            else:
                put(stats, path, leaf[len("running_"):], value)
        elif leaf == "weight":
            put(params, path, "kernel", value.T)
        else:
            put(params, path, leaf, value)
    return {"params": params, "batch_stats": stats}
