"""Generator weights carried into the port.

* `generator_state_dict_from_jax` maps the reference package's flax
  Generator params (nested dicts of arrays, as `nelegan_tpu` trains them) to
  this package's state dict, which uses the reference torch keys.  An own
  copy of the layout logic of `nelegan_tpu/models/convert.py:78-102`.
* `load_reference_checkpoint` reads the generator of a reference
  `chkpt_GD.pt` (reference: train_nele.py:272-277).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def generator_state_dict_from_jax(params: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """flax Generator params -> state dict for `models.generator.Generator`.

    flax Conv kernel [k, in, out] -> Conv1d weight [out, in, k]; Dense kernel
    [in, out] -> Linear weight [out, in]; cLN gain/bias [C] -> [1, C, 1].
    Arrays keep their dtype; `load_state_dict` casts them to the module's."""
    n_blocks = sum(1 for name in params
                   if name.startswith("block") and name.endswith("_conv"))

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a))

    sd: Dict[str, torch.Tensor] = {}
    for i in range(n_blocks):
        conv = params[f"block{i}_conv"]["Conv_0"]
        sd[f"convolutions.{i}.0.conv.weight"] = t(
            np.asarray(conv["kernel"]).transpose(2, 1, 0))
        sd[f"convolutions.{i}.0.conv.bias"] = t(conv["bias"])
        cln = params[f"block{i}_cln"]
        sd[f"convolutions.{i}.2.gain0"] = t(
            np.asarray(cln["gain"]).reshape(1, -1, 1))
        sd[f"convolutions.{i}.2.bias0"] = t(
            np.asarray(cln["bias"]).reshape(1, -1, 1))
    for fc in ("fc1", "fc2"):
        sd[f"{fc}.weight"] = t(np.asarray(params[fc]["kernel"]).T)
        sd[f"{fc}.bias"] = t(params[fc]["bias"])
    return sd


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The generator state dict (``'enhance-model'``) of a reference
    ``chkpt_GD.pt``, on the CPU."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if "enhance-model" not in blob:
        raise KeyError(f"{path}: no 'enhance-model' entry "
                       f"(found {sorted(blob)})")
    return blob["enhance-model"]
