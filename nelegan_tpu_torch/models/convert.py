"""Weights and training state carried into the port.

* `generator_state_dict_from_jax` and `discriminator_state_dict_from_jax`
  map the reference package's flax params (nested dicts of arrays, as
  `nelegan_tpu` trains them) to this package's state dicts, which use the
  reference torch keys.  Own copies of the layout logic of
  `nelegan_tpu/models/convert.py:78-133`.
* `train_state_from_jax` carries a whole `nelegan_tpu` TrainState across:
  params, spectral u and v, Adam moments and counts, step counters.
* `reference_state_dicts` is the one reader of a reference `chkpt_*.pt`
  (reference: train_nele.py:272-277), `save_reference_checkpoint` its one
  writer; `load_reference_checkpoint` takes a file's generator.

Callers pass numpy arrays (``jax.tree.map(np.asarray, ...)``); nothing here
imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    """A torch tensor owning a copy of `a`'s data (arrays from JAX are
    read-only views)."""
    return torch.from_numpy(np.array(a))


def generator_state_dict_from_jax(params: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """flax Generator params -> state dict for `models.generator.Generator`.

    flax Conv kernel [k, in, out] -> Conv1d weight [out, in, k]; Dense kernel
    [in, out] -> Linear weight [out, in]; cLN gain/bias [C] -> [1, C, 1].
    Arrays keep their dtype; `load_state_dict` casts them to the module's."""
    n_blocks = sum(1 for name in params
                   if name.startswith("block") and name.endswith("_conv"))
    sd: Dict[str, torch.Tensor] = {}
    for i in range(n_blocks):
        conv = params[f"block{i}_conv"]["Conv_0"]
        sd[f"convolutions.{i}.0.conv.weight"] = _t(
            np.asarray(conv["kernel"]).transpose(2, 1, 0))
        sd[f"convolutions.{i}.0.conv.bias"] = _t(conv["bias"])
        cln = params[f"block{i}_cln"]
        sd[f"convolutions.{i}.2.gain0"] = _t(
            np.asarray(cln["gain"]).reshape(1, -1, 1))
        sd[f"convolutions.{i}.2.bias0"] = _t(
            np.asarray(cln["bias"]).reshape(1, -1, 1))
    for fc in ("fc1", "fc2"):
        sd[f"{fc}.weight"] = _t(np.asarray(params[fc]["kernel"]).T)
        sd[f"{fc}.bias"] = _t(params[fc]["bias"])
    return sd


def _disc_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax discriminator trunk params (or a tree shaped like them, such as
    an Adam moment) -> torch names: SNConv2D kernel [kh, kw, in, out] ->
    weight_orig [out, in, kh, kw]; SNDense [in, out] -> [out, in]."""
    sd: Dict[str, torch.Tensor] = {}
    n_conv = sum(1 for name in params if name.startswith("conv"))
    for i in range(n_conv):
        conv = params[f"conv{i}"]
        sd[f"layers.{i}.weight_orig"] = _t(
            np.asarray(conv["weight_orig"]).transpose(3, 2, 0, 1))
        sd[f"layers.{i}.bias"] = _t(conv["bias"])
    for fc in ("fc1", "fc2", "fc3"):
        sd[f"{fc}.weight_orig"] = _t(np.asarray(params[fc]["weight_orig"]).T)
        sd[f"{fc}.bias"] = _t(params[fc]["bias"])
    return sd


def discriminator_state_dict_from_jax(variables: Mapping[str, Any]
                                      ) -> Dict[str, torch.Tensor]:
    """flax discriminator variables ``{'params', 'spectral'}`` -> state dict
    for `models.discriminator`, the stored power-iteration vectors carried
    over as ``weight_u`` / ``weight_v``."""
    sd = _disc_params(variables["params"]["trunk"])
    for name, uv in variables["spectral"]["trunk"].items():
        prefix = f"layers.{name[4:]}" if name.startswith("conv") else name
        sd[f"{prefix}.weight_u"] = _t(uv["u"])
        sd[f"{prefix}.weight_v"] = _t(uv["v"])
    return sd


def _adam(opt) -> Any:
    """The scale_by_adam state (count, mu, nu) of an optax.adam state,
    a chain whose first element it is."""
    return opt[0] if isinstance(opt, (tuple, list)) else opt


def _load_adam(opt: torch.optim.Adam, module: torch.nn.Module, adam,
               to_sd) -> None:
    """Put optax's (count, mu, nu) into a torch Adam as (step, exp_avg,
    exp_avg_sq), each moment laid out like its parameter."""
    mu, nu = to_sd(adam.mu), to_sd(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    names = [name for name, _ in module.named_parameters()]
    sd = opt.state_dict()
    sd["state"] = {i: {"step": step.clone(), "exp_avg": mu[name],
                       "exp_avg_sq": nu[name]}
                   for i, name in enumerate(names)}
    opt.load_state_dict(sd)


def train_state_from_jax(state, cfg=None, device=None):
    """A `nelegan_tpu.train.gan.TrainState` whose leaves are numpy arrays ->
    the port's `train.gan.TrainState` on `device` (None: CUDA), in the
    dtype of the arrays: the three param trees, both spectral
    collections, the three optax Adam states (count, mu, nu -> step,
    exp_avg, exp_avg_sq) and step_g / step_d.  `cfg` (default `Config()`)
    gives the shapes."""
    from nelegan_tpu_torch.config import Config
    from nelegan_tpu_torch.train.gan import init_train_state

    kernel = np.asarray(state.gen_params["fc1"]["kernel"])
    dtype = getattr(torch, kernel.dtype.name)
    out = init_train_state(cfg or Config(), 0, device, dtype=dtype)
    out.gen.load_state_dict(generator_state_dict_from_jax(state.gen_params),
                            strict=True)
    out.d.load_state_dict(discriminator_state_dict_from_jax(
        {"params": state.d_params, "spectral": state.d_spectral}),
        strict=True)
    out.dq.load_state_dict(discriminator_state_dict_from_jax(
        {"params": state.dq_params, "spectral": state.dq_spectral}),
        strict=True)
    _load_adam(out.gen_opt, out.gen, _adam(state.gen_opt),
               generator_state_dict_from_jax)
    _load_adam(out.d_opt, out.d, _adam(state.d_opt),
               lambda tree: _disc_params(tree["trunk"]))
    _load_adam(out.dq_opt, out.dq, _adam(state.dq_opt),
               lambda tree: _disc_params(tree["trunk"]))
    out.step_g = int(np.asarray(state.step_g))
    out.step_d = int(np.asarray(state.step_d))
    return out


# a reference chkpt_*.pt's entries, by the TrainState slot each one fills
# (reference: train_nele.py:76-85)
REFERENCE_ENTRIES = {"gen": "enhance-model", "d": "intel-model",
                     "dq": "quality-model"}


def reference_state_dicts(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """The model entries of a reference ``chkpt_*.pt`` that it holds, on the
    CPU, keyed by slot: ``'gen'`` ('enhance-model'), ``'d'``
    ('intel-model'), ``'dq'`` ('quality-model').  KeyError if it holds
    none."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    found = {slot: blob[key] for slot, key in REFERENCE_ENTRIES.items()
             if key in blob}
    if not found:
        raise KeyError(f"{path}: no model entry (found {sorted(blob)})")
    return found


def save_reference_checkpoint(path: str,
                              state_dicts: Mapping[str, Mapping[str, Any]]
                              ) -> str:
    """Write a reference ``chkpt_*.pt`` of the given slots (``'gen'``,
    ``'d'``, ``'dq'``, each a state dict of this package's models), on the
    CPU, under the reference's entry names: the inverse of
    `reference_state_dicts`."""
    blob = {REFERENCE_ENTRIES[slot]: {k: v.detach().cpu()
                                      for k, v in sd.items()}
            for slot, sd in state_dicts.items()}
    torch.save(blob, path)
    return path


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The generator state dict (``'enhance-model'``) of a reference
    ``chkpt_GD.pt``, on the CPU."""
    found = reference_state_dicts(path)
    if "gen" not in found:
        raise KeyError(f"{path}: no 'enhance-model' entry")
    return found["gen"]
