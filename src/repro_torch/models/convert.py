"""Parameters between the reference's pytree and the port, as plain arrays.

``lm_params_from_numpy`` takes the reference's ``init_lm`` (or
``init_vlm``) parameters as numpy arrays (``jax.tree.map(np.asarray,
params)``: nested dicts, the stack stacked per period; a MoE layer's
``norm``, float32 ``router``, ``w_gate``, ``w_up`` and ``w_down``) and
returns the port's parameter dict on `device`, checked leaf by leaf against
the port's own shapes and types.  ``encdec_params_from_numpy`` does the
same for ``init_encdec``'s tree (``enc_stack``, ``dec_stack`` with
``attn``, ``cross`` and ``mlp``, ``enc_norm``, ``final_norm``, ``embed``,
``unembed``).  ``lm_params_to_numpy`` takes any of the port's parameter
trees the other way, for the tests.  ``train_state_from_numpy`` and
``train_state_to_numpy`` do the same for a whole ``TrainState`` (the
parameters, the float32 moments m and v shaped like them, and the step),
so that tests start both packages' training from one state.  None imports
the reference: the arrays are the interface.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import ArchConfig
from .encdec import init_encdec
from .lm import init_lm, tree_map

__all__ = ["lm_params_from_numpy", "encdec_params_from_numpy",
           "lm_params_to_numpy", "train_state_from_numpy",
           "train_state_to_numpy"]


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy keeps bfloat16 as an extension type torch cannot read;
        # its bits are torch's bfloat16 bits
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _same_keys(want: dict, got: dict, path: str = "") -> None:
    if not isinstance(got, dict) or set(want) != set(got):
        have = sorted(got) if isinstance(got, dict) else type(got).__name__
        raise ValueError(f"parameter tree differs at {path or '<root>'}: "
                         f"expected keys {sorted(want)}, got {have}")
    for key, val in want.items():
        if isinstance(val, dict):
            _same_keys(val, got[key], f"{path}/{key}")


def lm_params_from_numpy(cfg: ArchConfig, tree: dict,
                         device: "torch.device | str" = "cuda") -> dict:
    """The reference's LM parameter tree (numpy leaves) -> the port's
    parameters on `device`, each leaf in the port's type for it."""
    return _from_numpy(init_lm(cfg, None, device="meta"), tree, device)


def encdec_params_from_numpy(cfg: ArchConfig, tree: dict,
                             device: "torch.device | str" = "cuda") -> dict:
    """The reference's encoder-decoder parameter tree (numpy leaves) -> the
    port's parameters on `device`."""
    return _from_numpy(init_encdec(cfg, None, device="meta"), tree, device)


def _from_numpy(shapes: dict, tree: dict, device) -> dict:
    _same_keys(shapes, tree)

    def convert(path, want, a):
        t = _to_tensor(a, device)
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, expected "
                             f"{tuple(want.shape)}")
        return t.to(want.dtype)

    def walk(want, got, path=""):
        if isinstance(want, dict):
            return {k: walk(want[k], got[k], f"{path}/{k}") for k in want}
        return convert(path, want, got)

    return walk(shapes, tree)


def lm_params_to_numpy(params: dict) -> dict:
    """The port's parameters -> numpy arrays on the host; bfloat16 leaves
    widen exactly to float32."""
    def conv(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(conv, params)


def _params_from_numpy(cfg: ArchConfig, tree: dict, device) -> dict:
    if cfg.family == "encdec":
        return encdec_params_from_numpy(cfg, tree, device)
    return lm_params_from_numpy(cfg, tree, device)


def train_state_from_numpy(cfg: ArchConfig, params_tree: dict,
                           opt_tree: dict, step: int,
                           device: "torch.device | str" = "cuda"):
    """A ``repro_torch.train.TrainState`` on `device` from numpy trees: the
    reference's parameters (any family), ``opt_tree`` {"m", "v"} (float32
    trees shaped like the parameters) and the step (the state's and the
    optimizer's, int32)."""
    from ..train.step import TrainState

    params = _params_from_numpy(cfg, params_tree, device)
    f32 = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                         device="meta"), params)
    opt = {key: _from_numpy(f32, opt_tree[key], device) for key in ("m", "v")}
    opt["step"] = torch.tensor(step, dtype=torch.int32, device=device)
    return TrainState(params=params, opt=opt,
                      step=torch.tensor(step, dtype=torch.int32,
                                        device=device))


def train_state_to_numpy(state) -> tuple[dict, dict, int]:
    """(params, {"m", "v"}, step) as numpy trees on the host; bfloat16
    leaves widen exactly to float32."""
    return (lm_params_to_numpy(state.params),
            {key: lm_params_to_numpy(state.opt[key]) for key in ("m", "v")},
            int(state.step))
