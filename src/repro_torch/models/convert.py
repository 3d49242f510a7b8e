"""Carry a JAX ``LM``'s parameters across into the port's ``LM``.

JAX keeps a parameter tree: ``embed``, ``final_norm`` (``final_norm_b``),
``lm_head`` (and an encoder-decoder's ``enc_final_norm``,
``enc_final_norm_b``) at the top, and the sublayers of one period stacked
over ``n_periods`` under ``blocks["{i}:{kind}"][name]``, each leaf of shape
(n_periods, ...). Slice p of each stacked leaf becomes
``lm.layers[p]["{i}:{kind}"][name]``, the cross-attention leaves ``x_*``
among them; an encoder's layers, stacked over ``enc_layers`` under
``enc_blocks["0:attn"][name]``, become ``lm.encoder[n]["0:attn"][name]``. Matrices keep JAX's ``x @ w``
orientation, (in, out), which is the port's too, so nothing is transposed.
Each leaf keeps its own dtype: a bf16 tree's router, ``A_log``, ``D`` and
``dt_bias`` are float32 in both packages, and a leaf whose dtype differs
from the port's is refused, never cast. The tree arrives as numpy arrays
(``jax.device_get`` or ``np.asarray`` on each leaf): the port imports
nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import LM


def lm_from_jax(cfg: ArchConfig, params: dict, *,
                device: str | torch.device = "cuda") -> LM:
    """JAX ``LM.init_params`` tree of numpy arrays -> the port's ``LM`` on
    ``device``, in the tree's dtype (float32 or bfloat16; the embedding's).
    Raises on a missing, extra, misshapen or differently typed
    parameter."""
    lm = LM(cfg, dtype=_torch_dtype(np.asarray(params["embed"]).dtype),
            device=device)
    stacked = {"blocks": ({f"{i}:{kind}" for i, kind in enumerate(cfg.period)},
                          [(n, f"{i}:{kind}", sub)
                           for n, i, kind, sub in lm.sublayers()])}
    if cfg.enc_layers:
        stacked["enc_blocks"] = ({"0:attn"},
                                 [(n, "0:attn", blk["0:attn"])
                                  for n, blk in enumerate(lm.encoder)])
    for tree, (keys, subs) in stacked.items():
        if tree not in params or set(params[tree]) != keys:
            raise ValueError(f"expected {tree} of the period {sorted(keys)}; "
                             f"got {sorted(params.get(tree, ()))}")
        for n, key, sub in subs:
            _load(sub, {k: np.asarray(v)[n]
                        for k, v in params[tree][key].items()},
                  f"{tree}[{key!r}][{n}]")
    _load(lm.top, {k: v for k, v in params.items() if k not in stacked},
          "params")
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
        if _torch_dtype(arr.dtype) != w.dtype:
            raise TypeError(f"{where}[{name!r}]: dtype {arr.dtype}, the port "
                            f"holds {w.dtype}")
        if arr.dtype.name == "bfloat16":
            # numpy has no bfloat16: move its bits, then reinterpret
            t = torch.from_numpy(np.array(arr).view(np.int16))
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        w.copy_(t)
