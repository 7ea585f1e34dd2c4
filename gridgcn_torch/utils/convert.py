"""Weights carried across: flax variables → the port's state_dict.

`convert_flax_variables` takes the JAX package's unfolded variables as
numpy nested dicts ({"params": ..., "batch_stats": ...}) and returns a
state_dict whose keys are the flax module paths joined with dots:

  Dense      {kernel [in, out], bias}  → {weight [out, in], bias}
  BatchNorm  {scale, bias} + stats {mean, var}
             → {weight, bias, running_mean, running_var}

e.g. params/gridconv0/gca/edge_dense0/kernel → gridconv0.gca.edge_dense0.
weight. Flax's BatchNorm momentum 0.9 is torch's 0.1 and both use eps 1e-5;
the port's own `models.fold.fold_inference` folds the result.
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
