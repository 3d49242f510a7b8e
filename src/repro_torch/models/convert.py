"""Carry a JAX ``LM``'s parameters across into the port's ``LM``.

JAX keeps a parameter tree: ``embed``, ``final_norm`` (``final_norm_b``),
``lm_head`` at the top, and the layers stacked over ``n_periods`` under
``blocks["0:attn"][name]``, each leaf of shape (n_layers, ...). Slice i of
each stacked leaf becomes ``lm.layers[i][name]``. Matrices keep JAX's
``x @ w`` orientation, (in, out), which is the port's too, so nothing is
transposed. The tree arrives as numpy arrays (``jax.device_get`` or
``np.asarray`` on each leaf): the port imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import LM


def lm_from_jax(cfg: ArchConfig, params: dict, *,
                device: str | torch.device = "cuda") -> LM:
    """JAX ``LM.init_params`` tree of numpy arrays -> the port's ``LM`` on
    ``device``, in the tree's dtype (float32 or bfloat16). Raises on a
    missing, extra or misshapen parameter."""
    lm = LM(cfg, dtype=_torch_dtype(np.asarray(params["embed"]).dtype),
            device=device)
    blocks = params["blocks"]
    if set(blocks) != {"0:attn"}:
        raise ValueError(f"expected one dense period '0:attn'; got "
                         f"{sorted(blocks)}")
    stacked = blocks["0:attn"]
    top = {k: v for k, v in params.items() if k != "blocks"}
    _load(lm.top, top, "params")
    for i, layer in enumerate(lm.layers):
        _load(layer, {k: np.asarray(v)[i] for k, v in stacked.items()},
              f"blocks['0:attn'][{i}]")
    return lm


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    if dt == np.float32:
        return torch.float32
    if dt.name == "bfloat16":          # ml_dtypes' bfloat16, as JAX hands it
        return torch.bfloat16
    raise TypeError(f"unsupported parameter dtype {dt}")


@torch.no_grad()
def _load(dest, src: dict, where: str) -> None:
    if set(dest) != set(src):
        raise ValueError(f"{where}: the port has {sorted(dest)}, the JAX "
                         f"tree {sorted(src)}")
    for name, arr in src.items():
        arr = np.asarray(arr)
        w = dest[name]
        if tuple(arr.shape) != tuple(w.shape):
            raise ValueError(f"{where}[{name!r}]: shape {arr.shape}, the port "
                             f"expects {tuple(w.shape)}")
        if arr.dtype.name == "bfloat16":
            # numpy has no bfloat16: move its bits, then reinterpret
            t = torch.from_numpy(np.array(arr).view(np.int16))
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        w.copy_(t)
