"""Multi-pod dry-run of the port: every (arch x shape x mesh) cell's real
step on fake tensors over a fake process group. The port of
``repro.launch.dryrun``.

For each cell this builds the port's own step (``make_train_step`` with its
in-place optimiser update on ``LM.stacked``, ``make_prefill_step`` or
``make_serve_step``) over ``DTensor`` parameters, optimiser state and batch
or cache, laid out by ``distributed.sharding``'s rules on the production
mesh (256 ranks single-pod, 512 multi-pod, or a variant's ``mesh_shape``)
of ``torch.testing._internal.distributed.fake_pg``'s group, and runs it
once under ``FakeTensorMode`` (nothing is allocated), ``implicit_replication``
and ``CommDebugMode``. The model's sharding constraints are JAX's
(``sharding.make_constrainer``); DTensor's propagation places every other
collective. One JSON record per cell goes to ``results/dryrun_torch/``
under JAX's file stems and record keys:

  * ``memory_analysis``: JAX's four keys, per rank. ``argument_size_in_bytes``
    is the local shards of parameters, optimiser state and batch or cache
    (an optimiser's step and a cache's length as JAX's int32 scalar);
    ``temp_size_in_bytes`` the peak of the bytes the step allocates beyond
    them, less its outputs; ``output_size_in_bytes`` the outputs it
    allocates (the train step updates parameters and state in place and
    returns its metrics); ``generated_code_size_in_bytes`` 0: nothing is
    compiled, the kernels are built once per process. The peak is counted
    from the storages the step's operations create and free, under the
    fake mode (``Recorder``); the caching allocator's rounding is not.
  * ``coll_by_kind``: the per-rank bytes of the collectives the step
    calls (each op's result, as JAX's HLO parse counts them) under JAX's
    kind names, handed to ``roofline.analyze``; ``comm_counts`` is
    ``CommDebugMode``'s count by op, archived under ``comms/`` where JAX
    wrote ``hlo/``. ``collectives_from`` says ``"CommDebugMode"``: it
    stands in for JAX's ``hloparse.py``.
  * ``fits``: argument + output + temp within ``core.hw.H100.hbm_bytes``.
  * ``local_regions``: the regions DTensor cannot propagate, run on each
    rank's shards under ``local_map`` with the placements JAX's
    constraints give them, and those where its propagation would issue
    collectives JAX's program does not (a partial sum reduced by each of
    its readers, in float32), reduced once where JAX reduces (``REGIONS``).
    No region is skipped and no op is dropped; each computes only what
    needs its collectives and calls the model's own functions for the
    rest. Their redistributions are explicit (``_redistribute``: no
    all-to-all), so torch releases and devices issue the same collectives
    there. A train or prefill step's residual stream keeps d on "model"
    between sublayers, as JAX's scan carry does, so each period's
    checkpoint saves a shard: a row-parallel output is reduce-scattered
    onto it, and each norm runs on the shard and gathers its output whole
    (``residual``, ``norm``).
    A decode step runs under the ``decode`` policy: every weight
    stays in its stored shard and only the token's activations, the cache
    and the state move, each by one explicit collective, so no decode
    collective is DTensor's. The tests hold the collective bytes of seven
    reduced cells to JAX's HLO count (``tests/test_torch_dryrun.py``).
  * ``no_effect``: each configuration field the port lacks.
  * ``lower_s``: the time to build the fake step; ``compile_s`` the time
    to run it.

Attention is kernel 8: on fake tensors its wrappers take the kernels' fake
path and on DTensors its sharding rule (``kernels/flash_attention/ops.py``),
so it is traced in every LM cell and launched by none.

``place_step`` lays a step out from any tensors: ``build_cell`` hands it
meta trees and fake shards, the tests real tensors on gloo ranks, so that
the count a cell reads on the fake group is checked against the same step
run for real.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \
        --mesh single
    python -m repro_torch.launch.dryrun --all            # every cell

The entry points default to ``device_type="cuda"``: the fake tensors carry
the card's device, as the real step's would. On a machine without a card
pass ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import logging
import math
import os
import sys
import time
import traceback
import weakref
from typing import Any, Callable

import torch

from repro_torch.configs import shapes as shp
from repro_torch.configs.registry import ALIASES, get_config
from repro_torch.core.hw import H100
from repro_torch.distributed import roofline as RL
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import build_mesh
from repro_torch.models import layers as L, mamba2, moe
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import leaf_groups
from repro_torch.models.model import LM
from repro_torch.training import lm_step, optim as O


# §Perf iteration variants: config/sharding deltas applied on top of an
# arch config, JAX's table.
VARIANTS = {
    "baseline": {},
    "remat_dots": {"cfg": {"remat_policy": "dots"}},
    "remat_none": {"cfg": {"remat": False}},
    "kv_seqshard": {"kv_seq_shard": True},
    "tp_only": {"fsdp": False},
    "tp_remat_dots": {"fsdp": False, "cfg": {"remat_policy": "dots"}},
    "tp_kvseq": {"fsdp": False, "kv_seq_shard": True},
    "wgather": {"cfg": {"fsdp_weight_gather": True}},
    "stack_fsdp": {"fsdp_mode": "stack"},
    "stack_wgather": {"fsdp_mode": "stack",
                      "cfg": {"fsdp_weight_gather": True}},
    "stack_wg_dots": {"fsdp_mode": "stack",
                      "cfg": {"fsdp_weight_gather": True,
                              "remat_policy": "dots"}},
    "noconstr": {"cfg": {"activation_constraints": False}},
    "tp_noconstr": {"fsdp": False,
                    "cfg": {"activation_constraints": False}},
    "tp_nc_dots": {"fsdp": False,
                   "cfg": {"activation_constraints": False,
                           "remat_policy": "dots"}},
    "tp_nc_kvseq": {"fsdp": False, "kv_seq_shard": True,
                    "cfg": {"activation_constraints": False}},
    "moe_local": {"cfg": {"moe_buf_mode": "local"}},
    "moe_local_nc": {"cfg": {"moe_buf_mode": "local",
                             "activation_constraints": False}},
    "gqa_repeat": {"cfg": {"attn_gqa_mode": "repeat"}},
    "gqa_dots": {"cfg": {"attn_gqa_mode": "repeat", "remat_policy": "dots"}},
    "gqa_kvseq": {"kv_seq_shard": True,
                  "cfg": {"attn_gqa_mode": "repeat"}},
    "opt_moe": {"cfg": {"attn_gqa_mode": "repeat", "moe_buf_mode": "local"}},
    # beyond-paper sharding scheme: same 256 chips, re-meshed 64x4 so the
    # Megatron AR payload (B_local*S*d) shrinks 4x and DP grows; params must
    # fit at TP=4 (planner-checked). "a different sharding scheme" per §Perf.
    "mesh_tp4": {"mesh_shape": (64, 4), "fsdp": False,
                 "cfg": {"attn_gqa_mode": "repeat"}},
    "mesh_tp4_fsdp": {"mesh_shape": (64, 4),
                      "cfg": {"attn_gqa_mode": "repeat"}},
    "opt_decode": {"kv_seq_shard": True, "fsdp": False,
                   "cfg": {"attn_gqa_mode": "repeat"}},
    # mesh_tp4 + ZeRO-1: optimizer state sharded over data (m/v live once
    # across the fleet); params stay TP-only. Fixes tp4's HBM overshoot for
    # the price of one grad reduce-scatter + param all-gather per step.
    "mesh_tp4_z1": {"mesh_shape": (64, 4), "fsdp": False, "opt_fsdp": True,
                    "cfg": {"attn_gqa_mode": "repeat"}},
    "mesh_tp4_z1_dots": {"mesh_shape": (64, 4), "fsdp": False,
                         "opt_fsdp": True,
                         "cfg": {"attn_gqa_mode": "repeat",
                                 "remat_policy": "dots"}},
    "mesh_tp2_z1": {"mesh_shape": (128, 2), "fsdp": False, "opt_fsdp": True,
                    "cfg": {"attn_gqa_mode": "repeat"}},
    "moe_shmap": {"cfg": {"moe_buf_mode": "shard_map",
                          "attn_gqa_mode": "repeat"}},
}

#: JAX's collective kinds by the name of a c10d or functional collective op
KINDS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "allgather_coalesced_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "shard_dim_alltoall": "all-to-all",
}
#: DTensor's sharding propagation, whose ops run on global shapes
_PROPAGATION = (os.path.join("distributed", "tensor", "_sharding_prop.py"),
                os.path.join("distributed", "tensor", "_op_schema.py"))
#: the namespaces of collective ops, and the name CommDebugMode counts
#: each under
_COLLECTIVE_NS = {"_c10d_functional": "c10d_functional",
                  "c10d_functional": "c10d_functional", "c10d": "c10d",
                  "_c10d_functional_autograd": "c10d_functional",
                  "_dtensor": "_dtensor"}

#: the regions DTensor cannot propagate, or propagates into collectives
#: JAX's partitioned program does not issue: each run under ``local_map``
#: or a redistribution on JAX's placements
REGIONS = {
    "moe_ffn": "models/moe.py::moe_ffn: the dispatch scatter "
               "(aten.index_add_) has no DTensor sharding strategy; each "
               "rank runs moe.local_experts (or moe_ffn) on its rows "
               "(JAX's ('data', None, None) on x) and its experts' shards "
               "(E or f on 'model'), its part of the output a Partial sum "
               "over 'model'; the load-balance loss from moe.balance's "
               "means summed over the data dims (both in one all-reduce), "
               "as over the whole batch, the same on every model rank and "
               "its gradient carried by model rank 0",
    "moe_ffn_shard_map": "models/moe.py::moe_ffn_shard_map: JAX's "
                         "shard_map; each rank runs moe.shard_map_body on "
                         "its rows and its E / model experts (JAX's in_specs)",
    "embed": "models/model.py::LM._lookup: the backward of DTensor's "
             "vocab-sharded lookup (MaskPartial) fails on (B, S) tokens; "
             "each rank looks its rows' tokens up in its vocab shard (the "
             "table gathered over the data axes, its gradient left a "
             "partial sum, as a tied head's is; in a decode step the "
             "tokens gathered instead and looked up in the table's stored "
             "d shard), the shards' rows summed over 'model' once, in the "
             "table's dtype",
    "decode_attention": "models/layers.py::decode_attention: DTensor cannot "
                        "propagate the GQA regrouping of q over a sharded "
                        "head or head_dim; each rank attends over its shard "
                        "of the cache (batch, KV heads, head_dim or "
                        "sequence as cache_pspecs lays it out), partial "
                        "scores all-reduced over a sharded head_dim, the "
                        "softmax's max and sum and the output over a "
                        "sharded sequence",
    "gelu_mlp": "models/layers.py::gelu_mlp: DTensor (torch 2.11) cannot "
                "add a sharded bias to the partial product its propagation "
                "picks after a sharded layernorm; each rank runs gelu_mlp "
                "on the Megatron split, its rows with the hidden dim on "
                "'model' (JAX's w_in / w_out specs), b_out in the first "
                "model rank's term alone, the output a partial sum over "
                "'model' for the residual region to reduce",
    "split_heads": "models/model.py::LM._split_heads, _merge_heads: "
                   "DTensor refuses to split a projection's columns "
                   "sharded over a mesh dim that does not divide its heads "
                   "(XLA reshards without a word); the columns are "
                   "gathered whole on that dim first, heads replicated "
                   "there as JAX's q/k spec falls back, and so is the "
                   "gradient of the merged attention output before the "
                   "merge's backward splits it",
    "loss": "models/model.py::LM._nll: the gold logit's gather on "
            "vocab-sharded logits (MaskPartial) fails as the lookup's "
            "backward does; each rank takes its rows' log-sum-exp and gold "
            "logit over its vocab shard, max and sums all-reduced over "
            "'model' (LM.loss's mask and mean stay the model's)",
    "cache_store": "models/model.py::LM._store: DTensor's select of one "
                   "position of a cache sharded over its sequence gathers "
                   "a copy, and the decode step's write into it is lost; "
                   "the new K or V is laid out as the cache (by "
                   "_redistribute) and the rank that holds the position "
                   "writes it into its shard",
    "mamba2_decode_step": "models/mamba2.py::mamba2_decode_step: DTensor "
                          "cannot propagate the (B, H) batched product of "
                          "the state over sharded heads; each rank steps "
                          "the cache's heads with the mixer's weights in "
                          "their stored shards (in_proj's partial columns "
                          "reduced once and gathered, the conv on the "
                          "rank's channels, out_proj row-parallel), the "
                          "state and window left in the cache's layout",
    "decode": "models/model.py::LM.decode_step, _proj, _out, "
              "models/layers.py::swiglu, chunked_attention: the decode "
              "policy. DTensor's products of a decode step gather whole "
              "FSDP weights where B is smaller than the data ranks, and "
              "pass the activations between tensor dims (an all-to-all on "
              "a card, an all-gather on a CPU mesh) in steps that move with "
              "torch; every weight stays in its stored shard and only the "
              "token's activations, the cache and the state move, each by "
              "one explicit collective (_redistribute): the residual "
              "stream's rows on the data dims, or its d where the rows do "
              "not divide them, each input cut to its weight's "
              "contraction shard and each partial product reduced once, "
              "JAX's constraints and the copied periods' gathers "
              "explicit",
    "fsdp_gather": "models/model.py::LM._proj: DTensor's head product "
                   "meets the rows' batch shard with the head's FSDP "
                   "contraction shard on the same data dims: on a mesh "
                   "with a dim of one rank it passes the batch shard to "
                   "the contraction dim (and back in the backward), "
                   "elsewhere it can sum the whole batch's logits "
                   "partially over the data dims (Whisper-tiny prefill_32k "
                   "1.49 GB of them at the peak, Mamba2-780M's 9.89 GB); "
                   "the head's FSDP weight is gathered over the data dims "
                   "at use instead, its gradient left a partial sum for "
                   "the grads region, as JAX's partitioner gathers it",
    "residual": "models/model.py::LM._residual, _carry: DTensor leaves "
                "a row-parallel product's output Partial over 'model' and "
                "each later reader reduces its own copy (the next norm "
                "twice, in float32), and a Python loop keeps no scan "
                "carry's layout; the residual stream of a train or prefill "
                "step enters each period with its rows on the data dims "
                "and d on 'model' (_stream_layout, JAX's scan carry: the "
                "remat saves that shard), and each output is reduced once, "
                "in its own dtype, to the placements the residual entered "
                "with (_redistribute: a reduce-scatter onto the d shard)",
    "norm": "models/model.py::LM._norm: DTensor's norm of a d-sharded x "
            "takes its own steps, and its backward on a Partial gradient "
            "(the column-parallel products' input gradient) reduces "
            "float32 intermediates; each rank normalises x where it lies, "
            "its scale cut as x's d is and, where d is sharded, its "
            "float32 sums all-reduced over the shards (their gradients "
            "too), then gathers the output whole over 'model' (one "
            "all-gather) for the products, whose input gradient is "
            "reduce-scattered back onto the shard once, in its own dtype; "
            "where x is whole, that gradient is all-reduced before the "
            "norm's backward, as JAX all-reduces it",
    "grads": "training/lm_step.py::_grad: DTensor leaves a parameter's "
             "gradient Partial over the mesh dims its work was split by "
             "and every reader reduces it anew (the gradient norm and the "
             "optimiser's float32 casts, three times a leaf); it is "
             "reduced once, in its own dtype, to its parameter's "
             "placements, as JAX's gradient takes its parameter's sharding",
    "grad_norm": "training/lm_step.py::_add_sq, _grad_norm: DTensor "
                 "reduces each gradient's sum of squares as it is added "
                 "(torch 2.11: two all-reduces a leaf) or once at the end "
                 "(2.13); each rank's sum of its shard (one copy on a "
                 "replicated dim) is added as a partial sum, reduced once "
                 "before the root, as JAX reduces the norm",
    "adafactor": "training/optim.py::factored_means, factored_moment, "
                 "factored_scale: DTensor lays the row and column means of "
                 "an expert leaf's squared gradient, and the outer product "
                 "of its factored moments, out as the moments are laid out "
                 "(experts on the data dims), not as the gradient is "
                 "(experts on 'model'), and moves the leaf-sized float32 "
                 "tensors between the two; each rank takes its shard's "
                 "means (a partial sum where the gradient splits the "
                 "reduced dim) and divides its shard of the gradient by "
                 "its shard of the product, as JAX's partitioner computes "
                 "the update in the gradient's sharding. The small factors "
                 "move between the two layouts gathered whole on the mesh "
                 "dims that change and cut there (_redistribute): DTensor's "
                 "all-to-all for a shard that changes dims is an "
                 "all-gather on a CPU mesh and takes other steps on other "
                 "torch releases",
    "qk_norm": "models/model.py::LM._qk_norm: DTensor multiplies q or k, "
               "whole on 'model' where the model dim does not divide its "
               "heads, by the norm's scale sharded on 'model' into a "
               "head_dim shard (torch 2.13), which the rope gathers back in "
               "float32; the (d_head,) scale is gathered first, as JAX's "
               "partitioner gathers it, so q and k keep their heads' "
               "placements",
    "wgather": "models/model.py::LM._gather_weights (cfg.fsdp_weight_gather): "
               "DTensor's redistribution of an FSDP weight to its TP-only "
               "spec reduces its gradient over each data dim in turn (an "
               "all-reduce over 'data', a reduce-scatter over 'pod'); each "
               "weight is gathered, and its gradient reduce-scattered, over "
               "both data dims in one collective (_DataGather), as JAX's "
               "partitioner does",
    "ssm_mixer": "models/mamba2.py::mamba2_mixer, _split_columns: DTensor "
                 "multiplies the whole activations by the mixer's "
                 "per-channel leaves (conv_w, conv_b, A_log, D, dt_bias, "
                 "norm), sharded on 'model', into shards it moves again "
                 "later, and splits the in_proj product's sharded columns "
                 "in steps that differ between torch releases; the leaves "
                 "are gathered first and the columns gathered whole before "
                 "the split, each by _DataGather",
    "ssd_chunked": "models/mamba2.py::ssd_chunked: DTensor does not finish "
                   "propagating its 5-D batched products; each rank runs it "
                   "on its batch rows and heads (JAX's ('data', None, None, "
                   "'model', None) on the chunks)",
}


def _quiet() -> None:
    """DTensor warns at every redistribution that crosses two mesh dims
    ("pod", "data"); the dry-run counts those collectives instead."""
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)


# ------------------------------------------------------------ recording
def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _tensors(x))


def tree_bytes(tree) -> int:
    """A tree's bytes on one rank: each tensor's local shard, each Python
    int (an optimiser's ``step``, a cache's ``len``) as JAX's int32
    scalar."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    return 4 if isinstance(tree, int) else 0


class Recorder:
    """A dispatch mode that counts, on this rank: each collective op's
    calls and result bytes (a c10d op's output argument), by op name; and
    the bytes of the storages the local operations create, live and at
    their peak, each freed when its storage is. It sees what a DTensor op
    desugars into, as ``CommDebugMode`` does, and leaves out the tensors of
    the global shape DTensor's sharding propagation makes to infer an
    output's. Storages that exist before (``exclude``) are never
    counted."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.weak import WeakIdKeyDictionary
        rec = self
        #: op name -> [calls, bytes]; and each call in order
        self.comms: dict[str, list[int]] = {}
        self.calls: list[tuple[str, int]] = []
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()

        from torch.distributed.tensor import DTensor

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    # as CommDebugMode: DTensor runs first and comes back
                    # here with the collectives and the local ops it
                    # desugars into
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                rec._op(func, args, out)
                return out

        self.mode = Mode()

    def exclude(self, tree) -> None:
        for t in _tensors(tree):
            self._seen[_local(t).untyped_storage()] = 0

    def _op(self, func, args, out) -> None:
        name = func._overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NS and name in KINDS:
            n = _nbytes(args[0] if func.namespace == "c10d" else out)
            key = f"{_COLLECTIVE_NS[func.namespace]}.{name}"
            entry = self.comms.setdefault(key, [0, 0])
            entry[0] += 1
            entry[1] += n
            self.calls.append((key, n))
        tensors = list(_tensors(out))
        if not tensors or self._propagating():
            return
        for t in tensors:
            st = _local(t).untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    @staticmethod
    def _propagating() -> bool:
        """Whether DTensor's sharding propagation is running the op on
        tensors of the global shape to learn its output's (no rank
        allocates those)."""
        f = sys._getframe(3)
        while f is not None:
            if f.f_code.co_filename.endswith(_PROPAGATION):
                return True
            f = f.f_back
        return False

    def _free(self, n: int) -> None:
        self.live -= n

    def new_bytes(self, tree) -> int:
        """The bytes of ``tree``'s storages that the operations created."""
        seen = {}
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            seen[id(st)] = self._seen.get(st, 0)
        return sum(seen.values())

    def by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for name, (_, n) in self.comms.items():
            kind = KINDS[name.split(".", 1)[1]]
            out[kind] = out.get(kind, 0) + n
        return out


@contextlib.contextmanager
def counting(recorder: Recorder):
    """CommDebugMode and ``recorder`` around a region (a real run's, or
    inside the fake mode); yields the CommDebugMode."""
    from torch.distributed.tensor.debug import CommDebugMode
    with CommDebugMode() as cm, recorder.mode:
        yield cm


def comm_counts(cm) -> dict[str, int]:
    """CommDebugMode's count by op name (``c10d_functional.all_reduce``)."""
    return {str(k): int(v) for k, v in cm.get_comm_counts().items() if v}


# -------------------------------------------------------------- regions
def _placements(mesh, shape, logical):
    return SH.to_placements(mesh, SH.spec(mesh, tuple(shape), logical))


def _dp_replicated(mesh, placements):
    """``placements`` with the data dims ("pod", "data") replicated: a
    region's view of an FSDP-sharded weight (gathered at use)."""
    from torch.distributed.tensor import Replicate
    dp = SH.dp_axes(mesh)
    return [Replicate() if n in dp else p
            for n, p in zip(mesh.mesh_dim_names, placements)]


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _offset(mesh, dims, n_local: int) -> int:
    """The global index of this rank's first element of a tensor dim of
    local size ``n_local`` sharded over the mesh dims ``dims`` (major
    first)."""
    off = 0
    for i in dims:
        off = off * mesh.size(i) + mesh.get_local_rank(i)
    return off * n_local


def _sum(t, mesh, i):
    """``t`` all-reduced (summed) over mesh dim ``i``; the backward is the
    identity: each rank's term takes the whole sum's gradient."""
    return moe._AllReduce.apply(t, mesh.get_group(i))


def _grads(ins, split):
    """``local_map``'s gradient placements for inputs placed ``ins``: on a
    mesh dim where an input is replicated and ``split`` (what the region's
    work is split by there: its rows, its experts, its heads) is not, each
    rank's gradient is its part of the sum, ``Partial``."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple([Partial() if p == Replicate() and d != Replicate() else p
                  for p, d in zip(pl, split)] for pl in ins)


def _split_by(*placements):
    """Per mesh dim, the first placement of ``placements`` that is not
    ``Replicate()`` (what a region's work is split by)."""
    from torch.distributed.tensor import Replicate
    return [next((p for p in ps if p != Replicate()), Replicate())
            for ps in zip(*placements)]


def _flat_group(mesh, dims):
    """The process group of ``mesh``'s dims ``dims`` flattened into one
    (the mesh's arithmetic runs outside the fake mode and the counters).
    DTensor's caches can hand a cell the equal mesh of an earlier cell,
    whose flattened dim names a group of the fake group destroyed since:
    that dim is flattened again in the group of this cell."""
    from torch.distributed import device_mesh as dm
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        try:
            return mesh[dims]._flatten().get_group()
        except (RuntimeError, KeyError, ValueError):
            # the root mesh keeps its flattened dims (torch 2.13), or the
            # mesh environment does by root (earlier releases)
            env = getattr(dm, "_mesh_resources", None)
            root = mesh._get_root_mesh() if hasattr(
                mesh, "_get_root_mesh") else env.get_root_mesh(mesh)
            name = "_".join(dims)
            getattr(root, "_flatten_mapping", {}).pop(name, None)
            getattr(env, "root_to_flatten_mapping", {}).get(
                root, {}).pop(name, None)
            return mesh[dims]._flatten().get_group()


def _redistribute(t, placements):
    """``t`` redistributed to ``placements`` a step at a time, each step
    that moves data one explicit collective: a mesh dim (or both data dims
    ("pod", "data") where they move together, as JAX's partitioner moves
    them over the flattened pair, pod major as the shards lie) gathered
    from ``Shard(i)`` or all-reduced from ``Partial()`` to
    ``Replicate()``, innermost first; then, outermost first, each cut to
    ``Shard(i)`` (locally, by DTensor) or reduce-scattered from
    ``Partial()``. A shard that changes tensor dims is gathered and cut.
    DTensor's own plan issues one collective a data dim (a gather of half
    the result before the whole, an all-reduce of the whole before the
    scatter), an all-to-all for a shard that changes dims (an all-gather on
    a CPU mesh), and takes other steps on other torch releases; here every
    release and device issues the same collectives. A step this cannot
    take explicitly (a shard nested inside another on the same tensor
    dim) is DTensor's."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    names = list(mesh.mesh_dim_names)
    dp = [names.index(a) for a in SH.dp_axes(mesh)]
    dst = list(placements)
    cur = list(t.placements)
    if cur == dst:
        return t
    units = [[i] for i in range(len(names))]
    if len(dp) == 2 and cur[dp[0]] == cur[dp[1]] and \
            dst[dp[0]] == dst[dp[1]] and cur[dp[0]] != dst[dp[0]]:
        units = [dp] + [[i] for i in range(len(names)) if i not in dp]
    # gathers and reductions to Replicate(), innermost unit first
    for u in sorted(units, key=max, reverse=True):
        a, b = cur[u[0]], dst[u[0]]
        if a != b and not a.is_replicate() and (
                b.is_replicate() or (isinstance(a, Shard) and
                                     isinstance(b, Shard))):
            t = _step(t, u, Replicate())
            cur = list(t.placements)
    # cuts and reduce-scatters, outermost unit first
    for u in sorted(units, key=min):
        if cur[u[0]] != dst[u[0]]:
            t = _step(t, u, dst[u[0]])
            cur = list(t.placements)
    return t


def _step(t, unit, b):
    """``t`` with the mesh dims ``unit`` (one, or the two data dims, which
    share a placement) moved to ``b``: one collective over their
    (flattened) group where data moves, none over a group of one rank,
    else DTensor's local step."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = t.device_mesh
    src = list(t.placements)
    a = src[unit[0]]
    dst = [b if i in unit else p for i, p in enumerate(src)]
    inner = [p for i, p in enumerate(src) if i > max(unit)]
    if math.prod(mesh.size(i) for i in unit) == 1:   # nothing moves
        return DTensor.from_local(t.to_local(), mesh, dst, run_check=False,
                                  shape=t.shape, stride=t.stride())

    def even(dim, placements):        # equal shards on every rank
        return t.shape[dim] % math.prod(
            mesh.size(i) for i, p in enumerate(placements)
            if p == Shard(dim)) == 0
    if isinstance(a, Shard) and b == Replicate() and a not in inner and \
            even(a.dim, src):
        kind = "gather"
    elif a == Partial() and isinstance(b, Shard) and b not in inner and \
            even(b.dim, dst):
        kind = "scatter"
    elif a == Partial() and b == Replicate():
        kind = "reduce"
    else:
        return t.redistribute(mesh, dst)
    names = mesh.mesh_dim_names
    group = _flat_group(mesh, tuple(names[i] for i in unit)) \
        if len(unit) > 1 else (mesh, unit[0])
    local = t.to_local().contiguous()     # torch 2.11's collectives ask it
    if kind == "gather":
        out = funcol.all_gather_tensor(local, a.dim, group)
    elif kind == "scatter":
        out = funcol.reduce_scatter_tensor(local, "sum", b.dim, group)
    else:
        out = funcol.all_reduce(local, "sum", group)
    out = out.wait() if hasattr(out, "wait") else out
    return DTensor.from_local(out, mesh, dst, run_check=False,
                              shape=t.shape, stride=t.stride())


class _DataGather(torch.autograd.Function):
    """A ``DTensor`` moved to ``placements`` by ``_redistribute`` (an FSDP
    weight gathered over the data dims at use, ``_dp_replicated``; columns
    gathered whole); its gradient, partial where the work was split, moved
    back to the input's placements the same way."""

    @staticmethod
    def forward(ctx, t, placements):
        ctx.placements = tuple(t.placements)
        return _redistribute(t, placements)

    @staticmethod
    def backward(ctx, g):
        return _redistribute(g, ctx.placements), None


class _Gather(_DataGather):
    """``_DataGather`` whose gradient comes back unreduced, Partial where
    it is Partial and the input's placements elsewhere. The two uses of a
    tied embedding (the lookup, the head) then meet as partial sums, which
    torch 2.11 cannot add to a sharded term, and are reduced once
    (``_grad_region``)."""

    @staticmethod
    def backward(ctx, g):
        pl = [p if p.is_partial() else q
              for p, q in zip(g.placements, ctx.placements)]
        return g.redistribute(g.device_mesh, pl), None


class _GradOnFirst(torch.autograd.Function):
    """The identity on a value every rank of a mesh dim computes alike; its
    gradient zero on all but the first (``first``), so that the inputs'
    gradients, summed over that dim, count it once."""

    @staticmethod
    def forward(ctx, t, first):
        ctx.first = first
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


# --------------------------------------------------------- decode policy
class _DecodeState:
    """The decode policy's state while a decode step runs (set by the
    ``decode_step`` region): whether it is on, and the inputs already moved
    to meet a weight (``_meet``'s memo: q's, k's and v's projections, or
    an FFN's gate and up, move their input once)."""
    on = False
    memo: dict = {}


_DECODE = _DecodeState()


def _decoding(t) -> bool:
    return _DECODE.on and _is_dtensor(t)


def _group(mesh, dims):
    """The process group of ``mesh``'s dims ``dims``: one dim's, or the
    dims flattened into one (a collective over both data dims at once)."""
    names = mesh.mesh_dim_names
    return _flat_group(mesh, tuple(names[i] for i in sorted(dims))) \
        if len(dims) > 1 else (mesh, dims[0])


def _all_reduce(t, group):
    import torch.distributed._functional_collectives as funcol
    out = funcol.all_reduce(t, "sum", group)
    return out.wait() if hasattr(out, "wait") else out


class _Psum(torch.autograd.Function):
    """A local tensor summed over a process group (one all-reduce); its
    gradient summed the same way, as each rank's copy of the sum feeds only
    its own shard of what follows (a norm's float32 sums over d shards)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _psum(t, mesh, dims):
    """``t``, a local tensor, all-reduced (summed) over ``mesh``'s dims
    ``dims`` in one collective (none where there are none; ``_Psum``)."""
    return _Psum.apply(t, _group(mesh, dims)) if dims else t


def _residual_layout(mesh, shape):
    """The decode step's residual stream (B, 1, d): the rows on the data
    dims where they divide them, else d on the data dims, as the FSDP
    weights hold it (one row against the weights' d shards: JAX's
    partitioner lays a single token out so)."""
    return _placements(mesh, shape, ("data", None, "data"))


def _cut_first(t, want):
    """``t`` with the cuts of ``want`` (a replicated mesh dim to a shard,
    local) taken first, where no other mesh dim shards that tensor dim:
    a gather on another mesh dim then moves the cut tensor, not the
    whole."""
    from torch.distributed.tensor import Shard
    cur = list(t.placements)
    mid = list(cur)
    for i, (a, b) in enumerate(zip(cur, want)):
        if a.is_replicate() and isinstance(b, Shard) and not any(
                j != i and b in (cur[j], want[j]) for j in range(len(cur))):
            mid[i] = b
    return _redistribute(t, mid) if mid != cur else t


def _meet(x, w, k_dim=0):
    """``x`` (..., K) moved (``_redistribute``) to meet the weight ``w``
    where it lies, its contraction dim ``k_dim`` (K): x's last dim cut as
    w's K is on each mesh dim that shards K, x whole on each mesh dim that
    shards another dim of w, and elsewhere x's rows as they lie. Memoised
    for the decode step: one move an input."""
    from torch.distributed.tensor import Replicate, Shard
    last = x.dim() - 1
    want = []
    for a, b in zip(x.placements, w.placements):
        if b == Shard(k_dim):
            want.append(Shard(last))
        elif isinstance(b, Shard) or a != Shard(0):
            want.append(Replicate())
        else:
            want.append(a)                        # the rows
    key = (id(x), tuple(want))
    if key not in _DECODE.memo:
        _DECODE.memo[key] = (x, _redistribute(_cut_first(x, want), want))
    return _DECODE.memo[key][1]


def _dot(x, w):
    """x (..., K) @ w (K, N) on w's stored shard (``_meet``): ``Partial()``
    on each mesh dim that splits K, N's shard where w's N is sharded,
    x's rows elsewhere."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    x = _meet(x, w)
    last = x.dim() - 1
    out = [Partial() if b == Shard(0) else Shard(last) if b == Shard(1)
           else a for a, b in zip(x.placements, w.placements)]
    return local_map(torch.matmul, out_placements=out,
                     in_placements=(list(x.placements), list(w.placements)),
                     device_mesh=x.device_mesh)(x, w)


def _settle(y, want):
    """``y``, a product's partial sums (``Partial()`` on the mesh dims that
    split its contraction) and its columns' shards, moved to ``want``: the
    sums reduced first (all-reduced, or reduce-scattered onto the rows),
    while the tensor is smallest, then the columns gathered. Where the sums
    end replicated and the columns are gathered over one mesh dim, one
    all-reduce over the sums' dims and that dim of the columns placed in
    zeros of the whole width replaces the two where it moves no more on
    the wire (an all-reduce counts twice; at a dim of two ranks the gather
    of the reduced half moves what the second half of the all-reduce
    does): one collective, as JAX's partitioner merges them."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Shard
    mesh, cur = y.device_mesh, list(y.placements)
    last = y.dim() - 1
    part = [i for i, a in enumerate(cur) if a.is_partial()]
    cols = [i for i, (a, b) in enumerate(zip(cur, want))
            if a == Shard(last) and b.is_replicate()]
    if part and len(cols) == 1 and all(want[i].is_replicate() for i in part):
        m = mesh.size(cols[0])
        if 2 * m <= 2 + m:          # one all-reduce's wire <= reduce + gather
            local = y.to_local()
            n = local.shape[-1]
            whole = local.new_zeros(local.shape[:-1] + (n * m,))
            at = mesh.get_local_rank(cols[0]) * n
            whole[..., at:at + n] = local
            out = funcol.all_reduce(whole, "sum", _group(mesh, part + cols))
            out = out.wait() if hasattr(out, "wait") else out
            return DTensor.from_local(out, mesh, want, run_check=False,
                                      shape=y.shape, stride=y.stride())
    mid = [want[i] if a.is_partial() else a for i, a in enumerate(cur)]
    return _redistribute(_redistribute(y, mid), want)


def _columns(h, y, heads=None):
    """Where a column-parallel product ``y`` of ``h`` goes: on each mesh dim
    that split its contraction, h's rows (a reduce-scatter onto them) or
    the whole (an all-reduce); its columns' shard kept where it holds whole
    heads (``heads`` None: any), else gathered."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, last = y.device_mesh, y.dim() - 1
    out = []
    for i, (a, b) in enumerate(zip(h.placements, y.placements)):
        if b.is_partial():
            out.append(Shard(0) if a == Shard(0) else Replicate())
        elif b == Shard(last) and heads is not None and \
                heads % mesh.size(i):
            out.append(Replicate())
        else:
            out.append(b)
    return out


def _column_product(h, w, heads=None):
    """h @ w on w's stored shard, reduced: ``_dot``, then ``_settle`` to
    ``_columns``."""
    y = _dot(h, w)
    return _settle(y, _columns(h, y, heads))


def _moe_region(real, used):
    def moe_ffn(x, p, *, n_experts, top_k, capacity_factor=1.0,
                constrain=None, buf_mode="e_sharded"):
        if not _is_dtensor(x):
            return real(x, p, n_experts=n_experts, top_k=top_k,
                        capacity_factor=capacity_factor, constrain=constrain,
                        buf_mode=buf_mode)
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        used.add("moe_ffn")
        if _decoding(x):
            return _moe_decode(x, p, n_experts, top_k, capacity_factor)
        mesh = x.device_mesh
        names = tuple(mesh.mesh_dim_names)
        rows = _placements(mesh, x.shape, ("data", None, None))
        rep = [Replicate()] * len(names)
        w = {k: _dp_replicated(mesh, p[k].placements)
             for k in ("w_gate", "w_up", "w_down")}
        m = names.index("model") if "model" in names else None
        split = m is not None and w["w_gate"][m] != Replicate()
        data = [i for i, pl in enumerate(rows) if pl != Replicate()]
        n_rows = math.prod(mesh.size(i) for i in data)
        # the data dims' group: both flattened into one where there are two
        data_groups = [_flat_group(mesh, tuple(names[i] for i in data))] \
            if len(data) > 1 else [mesh.get_group(i) for i in data]
        out_pl, aux_pl = list(rows), list(rep)
        if split:                     # each model rank a part of the sum
            out_pl[m] = Partial()
        kw = dict(n_experts=n_experts, top_k=top_k,
                  capacity_factor=capacity_factor)

        def local(x, router, wg, wu, wd):
            if split and w["w_gate"][m] == Shard(0):   # these experts
                lo = _offset(mesh, [m], wg.shape[0])
                out, _ = moe.local_experts(x, router, wg, wu, wd, lo, **kw)
            else:
                out, _ = real(x, {"router": router, "w_gate": wg,
                                  "w_up": wu, "w_down": wd},
                              constrain=constrain, buf_mode=buf_mode, **kw)
            # the load-balance loss over all the rows, as the unsharded
            # model takes it: its two means summed over the data dims
            probs = moe._probs(x, router)
            me, ce = moe.balance(probs, moe.topk(probs, top_k)[1],
                                 n_experts)
            for group in data_groups:
                me = moe._AllReduce.apply(me, group)
                ce = moe._AllReduce.apply(ce, group)
            aux = moe.balance_loss(me / n_rows, ce / n_rows)
            if split:            # the same on every model rank: one carries
                aux = _GradOnFirst.apply(aux, mesh.get_local_rank(m) == 0)
            return out, aux

        ins = (rows, rep, w["w_gate"], w["w_up"], w["w_down"])
        return local_map(local, out_placements=(out_pl, aux_pl),
                         in_placements=ins,
                         in_grad_placements=_grads(
                             ins, _split_by(rows, w["w_gate"])),
                         device_mesh=mesh, redistribute_inputs=True)(
            x, p["router"], *(_DataGather.apply(p[k], w[k])
                              for k in ("w_gate", "w_up", "w_down")))
    return moe_ffn


def _moe_decode(x, p, n_experts, top_k, capacity_factor):
    """The MoE FFN of a decode step on the experts' stored shards: x cut to
    their d shard (``_meet``; rows gathered where they lie on the same
    dims), each rank's experts (E on "model") or their f shard, the
    router's logits and the gate and up activations summed over the d
    shards (``local_experts``' ``psum``) -> (the output, Partial over
    "model" and its d shard on the data dims, the aux over every row)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    wg = p["w_gate"]
    mesh = wg.device_mesh
    x = _meet(x, wg, k_dim=1)
    d_dims = [i for i, b in enumerate(wg.placements) if b == Shard(1)]
    rows = [i for i, a in enumerate(x.placements) if a == Shard(0)]
    e_dims = [i for i, b in enumerate(wg.placements) if b == Shard(0)]
    split = [i for i, b in enumerate(wg.placements)
             if isinstance(b, Shard) and b != Shard(1)]
    out_pl = [Shard(2) if i in d_dims else Partial() if i in split else a
              for i, a in enumerate(x.placements)]

    def local(x, router, wg, wu, wd):
        lo = _offset(mesh, e_dims, wg.shape[0])
        out, r = moe.local_experts(
            x, router, wg, wu, wd, lo, n_experts=n_experts, top_k=top_k,
            capacity_factor=capacity_factor,
            psum=lambda t: _psum(t, mesh, d_dims))
        if not rows:                     # every row here: the batch's aux
            return out, r.aux.float()
        me, ce = moe.balance(moe._probs(x, router, lambda t: _psum(
            t, mesh, d_dims)), r.top_i, n_experts)
        me, ce = _psum(me, mesh, rows), _psum(ce, mesh, rows)
        n = math.prod(mesh.size(i) for i in rows)
        return out, moe.balance_loss(me / n, ce / n)

    ws = [p[k] for k in ("router", "w_gate", "w_up", "w_down")]
    return local_map(local, out_placements=(out_pl, [Replicate()] * mesh.ndim),
                     in_placements=tuple(list(t.placements)
                                         for t in [x] + ws),
                     device_mesh=mesh)(x, *ws)


def _shard_map_region(real, used):
    def moe_ffn_shard_map(x, p, *, n_experts, top_k, capacity_factor, mesh,
                          model_axis="model"):
        if not _is_dtensor(x):
            return real(x, p, n_experts=n_experts, top_k=top_k,
                        capacity_factor=capacity_factor, mesh=mesh,
                        model_axis=model_axis)
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        used.add("moe_ffn_shard_map")
        names = tuple(mesh.mesh_dim_names)
        rows = _placements(mesh, x.shape, ("data", None, None))
        rep = [Replicate()] * len(names)
        experts = [Shard(0) if n == model_axis else Replicate()
                   for n in names]
        body = functools.partial(
            moe.shard_map_body, n_experts=n_experts, top_k=top_k,
            capacity_factor=capacity_factor, mesh=mesh,
            model_axis=model_axis)
        # the body's own autograd functions sum the replicated inputs'
        # gradients, as JAX's shard_map transpose does
        return local_map(body, out_placements=(rows, rep),
                         in_placements=(rows, rep, experts, experts,
                                        experts),
                         device_mesh=mesh, redistribute_inputs=True)(
            x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    return moe_ffn_shard_map


def _drop_dim(placements, dim, split):
    """The placements of a tensor laid out ``placements`` after its dim
    ``dim`` is reduced away: ``split`` (``Partial()`` or ``Replicate()``)
    on each mesh dim that sharded it, a later dim's shard one lower."""
    from torch.distributed.tensor import Shard
    return [split if isinstance(p, Shard) and p.dim == dim else
            Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > dim else p
            for p in placements]


def _whole(t) -> bool:
    return _is_dtensor(t) and not any(p.is_partial() for p in t.placements)


def _moments_region(real, used):
    def factored_means(g2):
        if not _whole(g2):
            return real(g2)
        from torch.distributed.tensor import Partial
        from torch.distributed.tensor.experimental import local_map
        used.add("adafactor")
        nd, pl = g2.dim(), list(g2.placements)
        n_cols, n_rows = g2.shape[-2:]

        def local(g2):
            # a mean where the dim is whole here, else this shard's part
            rows = g2.mean(dim=-1) if g2.shape[-1] == n_rows else \
                g2.sum(dim=-1) / n_rows
            cols = g2.mean(dim=-2) if g2.shape[-2] == n_cols else \
                g2.sum(dim=-2) / n_cols
            return rows, cols

        return local_map(local, out_placements=(
            _drop_dim(pl, nd - 1, Partial()), _drop_dim(pl, nd - 2, Partial())),
            in_placements=(pl,), device_mesh=g2.device_mesh)(g2)
    return factored_means


def _moment_region(real, used):
    def factored_moment(v, beta, new):
        if not (_whole(v) and _is_dtensor(new)) or \
                tuple(new.placements) == tuple(v.placements):
            return real(v, beta, new)
        used.add("adafactor")
        return real(v, beta, _redistribute(new, v.placements))
    return factored_moment


def _scale_region(real, used):
    def factored_scale(g, vr, vc):
        if not _whole(g):
            return real(g, vr, vc)
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        used.add("adafactor")
        nd, pl, mesh = g.dim(), list(g.placements), g.device_mesh
        n = vr.shape[-1]
        on = [i for i, p in enumerate(vr.placements)
              if p == Shard(vr.dim() - 1)]

        def roots(vr):                  # sqrt(vr / mean(vr)), in vr's layout
            den = vr.sum(dim=-1, keepdim=True)
            for i in on:
                den = funcol.all_reduce(den, "sum", (mesh, i))
            return torch.sqrt(vr / (den / n))

        vr_pl = list(vr.placements)
        r = local_map(roots, out_placements=vr_pl, in_placements=(vr_pl,),
                      device_mesh=mesh)(vr)
        r_pl = _drop_dim(pl, nd - 1, Replicate())
        c_pl = _drop_dim(pl, nd - 2, Replicate())
        r, c = _redistribute(r, r_pl), _redistribute(torch.sqrt(vc), c_pl)

        def local(g, r, c):
            return g / (r[..., None] * c[..., None, :] + 1e-16)

        return local_map(local, out_placements=pl,
                         in_placements=(pl, r_pl, c_pl),
                         device_mesh=mesh)(g, r, c)
    return factored_scale


#: the Mamba-2 mixer's per-channel and per-head leaves
_SSM_LEAVES = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm")


def _mixer_region(real, used):
    def mamba2_mixer(x, p, cfg, constrain=None, state=None,
                     return_state=False):
        if _is_dtensor(x):
            from torch.distributed.tensor import Replicate
            rep = [Replicate()] * x.device_mesh.ndim
            leaves = [k for k in _SSM_LEAVES if _is_dtensor(p.get(k))
                      and list(p[k].placements) != rep]
            if leaves:
                used.add("ssm_mixer")
                p = {**p, **{k: _DataGather.apply(p[k], rep)
                             for k in leaves}}
        return real(x, p, cfg, constrain, state=state,
                    return_state=return_state)
    return mamba2_mixer


def _columns_region(real, used):
    def _split_columns(t, sizes):
        if _is_dtensor(t):
            from torch.distributed.tensor import Replicate, Shard
            last = Shard(t.dim() - 1)
            pl = [Replicate() if p == last else p for p in t.placements]
            if pl != list(t.placements):
                used.add("ssm_mixer")
                t = _DataGather.apply(t, pl)
        return real(t, sizes)
    return _split_columns


class _Reduced(torch.autograd.Function):
    """``t``'s partial sums reduced by ``_redistribute``; its gradient's
    too, since each rank's part takes the whole sum's gradient."""

    @staticmethod
    def forward(ctx, t):
        return _redistribute(t, _reduced(t.placements))

    @staticmethod
    def backward(ctx, g):
        return _redistribute(g, _reduced(g.placements))


def _reduced(placements):
    from torch.distributed.tensor import Replicate
    return [Replicate() if p.is_partial() else p for p in placements]


class _Moved(torch.autograd.Function):
    """``t`` moved to ``placements`` by ``_redistribute``; its gradient
    moved back to t's placements by ``_redistribute``, but where t was a
    partial sum, each rank's term takes the whole gradient: left partial
    where it is partial, else replicated (a shard gathered: the gradient
    of a row-parallel output reduce-scattered onto the residual's d
    shard)."""

    @staticmethod
    def forward(ctx, t, placements):
        ctx.placements = list(t.placements)
        return _redistribute(t, placements)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        return _redistribute(g, [
            (b if b.is_partial() else Replicate()) if a.is_partial() else a
            for a, b in zip(ctx.placements, g.placements)]), None


def _move(used, region, t, placements):
    """``t`` moved to ``placements`` (``_Moved``) where they differ, the
    move recorded as ``region``'s: the one redistribution of the
    ``residual``, ``norm`` and ``grads`` regions."""
    if _is_dtensor(t) and tuple(t.placements) != tuple(placements):
        used.add(region)
        t = _Moved.apply(t, placements)
    return t


def _skip_region(real, used):
    def _skip(y, D, x_in):
        if _is_dtensor(y) and list(x_in.placements) != list(y.placements):
            used.add("ssm_mixer")
            x_in = _DataGather.apply(x_in, list(y.placements))
        return real(y, D, x_in)
    return _skip


def _gated_norm_region(real, used):
    def _gated_norm_out(y, z, p, eps):
        if _is_dtensor(y) and list(z.placements) != list(y.placements):
            used.add("ssm_mixer")
            z = _DataGather.apply(z, list(y.placements))
        return real(y, z, p, eps)
    return _gated_norm_out


def _mean_last_region(real, used):
    def _mean_last(t):
        m = real(t)
        if _is_dtensor(m) and any(p.is_partial() for p in m.placements):
            used.add("ssm_mixer")
            m = _Reduced.apply(m)
        return m
    return _mean_last


def _ssd_region(real, used):
    def ssd_chunked(x, a, B_, C_, chunk, constrain=None, init_state=None):
        if not _is_dtensor(x):
            return real(x, a, B_, C_, chunk, constrain,
                        init_state=init_state)
        from torch.distributed.tensor.experimental import local_map
        used.add("ssd_chunked")
        mesh = x.device_mesh
        H, G = x.shape[2], B_.shape[2]
        heads = _placements(mesh, x.shape, ("data", None, "model", None))
        decay = _placements(mesh, a.shape, ("data", None, "model"))
        groups = heads if G == H else _placements(
            mesh, B_.shape, ("data", None, None, None))
        state = _placements(mesh, (x.shape[0], H, B_.shape[3], x.shape[3]),
                            ("data", "model", None, None))
        if G != H and G != 1 and heads != groups:
            raise NotImplementedError(
                f"the SSD region takes one group or one a head; got {G} "
                f"groups over {H} heads")

        def local(x, a, B_, C_, s=None):
            Hl = x.shape[2]
            if B_.shape[2] != Hl:        # one group: every local head's
                B_, C_ = (mamba2._expand_groups(t, Hl) for t in (B_, C_))
            return real(x, a, B_, C_, chunk, constrain, init_state=s)

        ins = (heads, decay, groups, groups)
        args = (x, a, B_, C_)
        if init_state is not None:
            ins, args = ins + (state,), args + (init_state,)
        # each input cut to its placements here, its gradient moved back by
        # _redistribute
        args = [_DataGather.apply(t, pl) for t, pl in zip(args, ins)]
        return local_map(local, out_placements=(heads, state),
                         in_placements=ins,
                         in_grad_placements=_grads(ins, heads),
                         device_mesh=mesh)(*args)
    return ssd_chunked


def _lookup_region(real, used):
    def _lookup(self, tokens):
        emb = self.top["embed"]
        if not _is_dtensor(emb):
            return real(self, tokens)
        import torch.nn.functional as F
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        used.add("embed")
        mesh = emb.device_mesh
        if _decoding(tokens):
            return _lookup_decode(tokens, emb)
        rows = _placements(mesh, tokens.shape, ("data", None))
        table = _dp_replicated(mesh, emb.placements)
        vocab = [i for i, pl in enumerate(table) if pl == Shard(0)]
        out_pl = [rows[i] if rows[i] != Replicate() else (
            Partial() if i in vocab else Replicate())
            for i in range(mesh.ndim)]

        def local(tok, w):                # the lookup in this vocab shard
            V = w.shape[0]
            idx = tok.long() - _offset(mesh, vocab, V)
            inside = (idx >= 0) & (idx < V)
            x = F.embedding(idx.clamp(0, V - 1), w)
            return x * inside[..., None].to(x.dtype)

        ins = (rows, table)
        x = local_map(local, out_placements=out_pl, in_placements=ins,
                      in_grad_placements=_grads(ins, rows),
                      device_mesh=mesh, redistribute_inputs=True)(
            tokens, _Gather.apply(emb, table))
        return _Moved.apply(x, rows)        # the vocab shards' rows summed
    return _lookup


def _lookup_decode(tokens, emb):
    """A decode step's lookup in the table's stored shard: the B tokens
    gathered where the table is cut (int32), each looked up in this
    rank's vocab and d shards, the vocab shards' rows summed and the rows
    laid out as the residual stream (``_residual_layout``)."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = emb.device_mesh
    tok_pl = [Replicate() if isinstance(b, Shard) else a
              for a, b in zip(tokens.placements, emb.placements)]
    vocab = [i for i, b in enumerate(emb.placements) if b == Shard(0)]
    out_pl = [Partial() if b == Shard(0) else Shard(2) if b == Shard(1)
              else a for a, b in zip(tok_pl, emb.placements)]

    def local(tok, w):                # the lookup in this vocab shard
        V = w.shape[0]
        idx = tok.long() - _offset(mesh, vocab, V)
        inside = (idx >= 0) & (idx < V)
        x = F.embedding(idx.clamp(0, V - 1), w)
        return x * inside[..., None].to(x.dtype)

    x = local_map(local, out_placements=out_pl,
                  in_placements=(tok_pl, list(emb.placements)),
                  device_mesh=mesh)(_redistribute(tokens, tok_pl), emb)
    return _redistribute(x, _residual_layout(
        mesh, tuple(tokens.shape) + (emb.shape[1],)))


def _decode_attention_region(real, used):
    def decode_attention(q, k_cache, v_cache, *, cache_len, window=None,
                         window_rotated=False):
        if not _is_dtensor(k_cache):
            return real(q, k_cache, v_cache, cache_len=cache_len,
                        window=window, window_rotated=window_rotated)
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        used.add("decode_attention")
        mesh = k_cache.device_mesh
        cpl = list(k_cache.placements)      # (B, Hkv, S, D)
        qpl = [pl if pl in (Shard(0), Shard(1), Shard(3)) else Replicate()
               for pl in cpl]
        on = {d: [i for i, pl in enumerate(cpl) if pl == Shard(d)]
              for d in (2, 3)}
        D = q.shape[3]

        def local(q, k, v):
            s = L.decode_scores(q, k, D)
            for i in on[3]:                   # head_dim: partial scores
                s = _sum(s, mesh, i)
            S_l = k.shape[2]
            kpos = _offset(mesh, on[2], S_l) + torch.arange(
                S_l, device=q.device)
            s = s.masked_fill(~L.decode_valid(kpos, cache_len, window,
                                              window_rotated), L.NEG_INF)
            # the softmax over a sharded sequence: its max and sum, and
            # the weighted values, summed over the shards
            m = s.amax(dim=-1, keepdim=True)
            for i in on[2]:
                m = funcol.all_reduce(m, "max", (mesh, i))
            e = torch.exp(s - m)
            den = e.sum(dim=-1, keepdim=True)
            out = torch.einsum("bhgk,bhkd->bhgd", e, v.float())
            for i in on[2]:
                den, out = _sum(den, mesh, i), _sum(out, mesh, i)
            out = out / den
            return out.reshape(q.shape[0], q.shape[1], 1,
                               -1).to(q.dtype)

        out = local_map(local, out_placements=qpl,
                        in_placements=(qpl, cpl, cpl), device_mesh=mesh)(
            _redistribute(q, qpl), k_cache, v_cache)
        # whole heads again before the (B, 1, Hq * D) flatten
        return _redistribute(out, [Replicate() if pl == Shard(3) else pl
                                   for pl in qpl])
    return decode_attention


def _residual_region(real, used):
    def _residual(self, x, y):
        if _is_dtensor(x):
            y = _move(used, "residual", y, x.placements)
        return real(self, x, y)
    return _residual


def _stream_layout(mesh, shape):
    """A train or prefill step's residual stream (B, S, d) between
    sublayers: the rows on the data dims, d on "model" where that dim has
    more than one rank and divides d, as JAX's program saves its scan
    carry (Qwen3-8B's ``bf16[36,16,4096,256]``); else d whole there."""
    names = tuple(mesh.mesh_dim_names)
    cut = "model" in names and mesh.size(names.index("model")) > 1
    return _placements(mesh, shape, ("data", None, "model" if cut else None))


def _carry_region(real, used):
    def _carry(self, x):
        if _is_dtensor(x):
            x = _move(used, "residual", x, _stream_layout(x.device_mesh,
                                                          x.shape))
        return real(self, x)
    return _carry


def _norm_region(real, used):
    def _norm(self, x, p, name="ln"):
        if not _is_dtensor(x):
            return real(self, x, p, name)
        from torch.distributed.tensor import Replicate, Shard
        used.add("norm")
        mesh, last = x.device_mesh, x.dim() - 1
        names = [k for k in (name, f"{name}_b") if p.get(k) is not None]
        # the scale (and bias) cut as x's d is
        pl = [Shard(0) if a == Shard(last) else Replicate()
              for a in x.placements]
        if _decoding(x):
            return _norm_at(self, x, [_fetch(p[k], pl) for k in names],
                            names, name, real)
        y = _norm_at(self, x, [
            p[k] if list(p[k].placements) == pl else
            _DataGather.apply(p[k], pl) for k in names], names, name, real)
        # the output whole over "model" for the column-parallel products;
        # their input gradient, partial there, reduce-scattered back
        return _move(used, "norm", y, [Replicate() if a == Shard(last)
                                       else a for a in y.placements])
    return _norm


def _norm_at(lm, x, ws, names, name, real):
    """The model's norm of x where it lies (a train or prefill step's
    residual stream, d on "model"; a decode step's, ``_residual_layout``),
    its scale and bias ``ws`` cut as x's d is: where d is sharded, its
    float32 sums over it all-reduced over the dims that shard it
    (``_psum``; their gradients too), so the float32 intermediates are a
    shard's; the model's own norm where it is whole. Each rank's scale
    gradient is its rows' part of the sum."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, last = x.device_mesh, x.dim() - 1
    dims = [i for i, a in enumerate(x.placements) if a == Shard(last)]
    d, eps = x.shape[-1], lm.cfg.norm_eps

    def local(x, *w):
        if not dims:
            return real(lm, x, dict(zip(names, w)), name)
        x32 = x.float()
        if lm.cfg.norm == "layernorm":
            mu = _psum(x32.sum(dim=-1, keepdim=True), mesh, dims) / d
            var = _psum(torch.square(x32 - mu).sum(dim=-1, keepdim=True),
                        mesh, dims) / d
            y = (x32 - mu) * torch.rsqrt(var + eps)
            return y.to(x.dtype) * w[0] + w[1]
        var = _psum((x32 * x32).sum(dim=-1, keepdim=True), mesh, dims) / d
        return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w[0]

    ins = (list(x.placements),) + tuple(list(w.placements) for w in ws)
    return local_map(local, out_placements=list(x.placements),
                     in_placements=ins,
                     in_grad_placements=_grads(ins, x.placements),
                     device_mesh=mesh)(x, *ws)


def _fetch(t, want):
    """``t`` (1-D) moved to ``want``, its blocks over other mesh dims:
    where ``t`` is cut over one mesh dim and each rank's wanted block lies
    in the stored block of one rank of that dim's group (a norm scale cut
    over "model", wanted in the residual's d shard over the data dims),
    that rank broadcasts the block over the group (one collective, JAX's
    collective-permute of it); else ``_redistribute``."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Shard
    mesh, n = t.device_mesh, t.shape[0]
    src = [i for i, a in enumerate(t.placements) if a == Shard(0)]
    dst = [i for i, b in enumerate(want) if b == Shard(0)]
    rest = [i for i, b in enumerate(want) if i not in dst]
    if len(src) != 1 or set(src) & set(dst) or not dst or \
            any(not t.placements[i].is_replicate() for i in rest
                if i not in src):
        return _redistribute(t, want)
    held = n // mesh.size(src[0])
    size = n // math.prod(mesh.size(i) for i in dst)
    if held % size or n % held or n % size:
        return _redistribute(t, want)
    off = _offset(mesh, dst, size)
    holder, at = divmod(off, held)
    local = t.to_local()
    block = local[at:at + size].contiguous() \
        if mesh.get_local_rank(src[0]) == holder else local.new_empty(size)
    out = funcol.broadcast(block, holder, (mesh, src[0]))
    out = out.wait() if hasattr(out, "wait") else out
    return DTensor.from_local(out, mesh, want, run_check=False,
                              shape=t.shape, stride=t.stride())


def _qk_norm_region(real, used):
    def _qk_norm(self, t, scale):
        if not _is_dtensor(scale) or all(p.is_replicate()
                                         for p in scale.placements):
            return real(self, t, scale)
        from torch.distributed.tensor import Replicate
        used.add("qk_norm")
        return real(self, t, _DataGather.apply(
            scale, [Replicate()] * scale.device_mesh.ndim))
    return _qk_norm


def _wgather_region(real, used):
    def _gather_weights(self, sub):
        con = self.constrain
        if con is None or not self.cfg.fsdp_weight_gather or \
                not any(_is_dtensor(v) for v in sub.values()):
            return real(self, sub)
        used.add("wgather")

        def gather(x, axes):               # to the TP-only spec, as con
            if not _is_dtensor(x):
                return con(x, axes)
            return _DataGather.apply(x, _placements(x.device_mesh, x.shape,
                                                    axes))
        gather.mesh = con.mesh
        self.constrain = gather
        try:
            return real(self, sub)
        finally:
            self.constrain = con
    return _gather_weights


def _add_sq_region(real, used):
    def _add_sq(sq, g):
        if not _is_dtensor(g):
            return real(sq, g)
        from torch.distributed.tensor import DTensor, Partial
        used.add("grad_norm")
        mesh = g.device_mesh
        local = torch.sum(torch.square(g.to_local().to(torch.float32)))
        for i, p in enumerate(g.placements):
            if p.is_replicate() and mesh.get_local_rank(i) != 0:
                local = local * 0     # one copy counts on a replicated dim
        s = DTensor.from_local(local, mesh, [Partial()] * mesh.ndim,
                               run_check=False)
        return s if sq is None else sq + s
    return _add_sq


def _grad_norm_region(real, used):
    def _grad_norm(sq):
        if not _is_dtensor(sq):
            return real(sq)
        from torch.distributed.tensor import Replicate
        used.add("grad_norm")
        return real(_redistribute(sq, [Replicate()] * sq.device_mesh.ndim))
    return _grad_norm


def _grad_region(real, used):
    def _grad(t):
        return _move(used, "grads", real(t), t.placements)
    return _grad


def _gelu_region(real, used):
    def gelu_mlp(x, w_in, b_in, w_out, b_out):
        if not _is_dtensor(x):
            return real(x, w_in, b_in, w_out, b_out)
        import torch.nn.functional as F
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        used.add("gelu_mlp")
        if _decoding(x):            # the stored shards, b_out added once
            h = F.gelu(_column_product(x, w_in) + b_in, approximate="tanh")
            return _redistribute(_dot(h, w_out), x.placements) + b_out
        mesh = x.device_mesh
        rows = _placements(mesh, x.shape, ("data", None, None))
        rep = [Replicate()] * mesh.ndim
        split = [i for i, pl in enumerate(_dp_replicated(
            mesh, w_in.placements)) if pl == Shard(1)]
        hid = [Shard(0) if i in split else Replicate()
               for i in range(mesh.ndim)]
        w_in_pl = [Shard(1) if i in split else Replicate()
                   for i in range(mesh.ndim)]
        # the hidden dim's partial sums, reduced by _residual; b_out in
        # the first rank's term alone
        first = float(all(mesh.get_local_rank(i) == 0 for i in split))

        def local(x, w_in, b_in, w_out, b_out):   # the Megatron split
            return real(x, w_in, b_in, w_out, b_out * first)

        ins = (rows, w_in_pl, hid, hid, rep)
        out = [Partial() if i in split else p for i, p in enumerate(rows)]
        return local_map(local, out_placements=out, in_placements=ins,
                         in_grad_placements=_grads(ins, _split_by(rows, hid)),
                         device_mesh=mesh, redistribute_inputs=True)(
            x, w_in, b_in, w_out, b_out)
    return gelu_mlp


def _proj_region(real, used):
    def _proj(self, h, w, heads=None):
        if _decoding(h):
            used.add("decode")
            return _column_product(h, w, heads)
        if heads is None and _is_dtensor(h) and _is_dtensor(w) and \
                _fsdp_rows(h, w):
            # the head's FSDP gather at use, as JAX's partitioner makes it
            # (DTensor meets the rows' batch shard on the contraction)
            used.add("fsdp_gather")
            w = _Gather.apply(w, _dp_replicated(w.device_mesh, w.placements))
        return real(self, h, w, heads)
    return _proj


def _fsdp_rows(h, w) -> bool:
    """Whether ``h``'s rows lie on a mesh dim that shards ``w``'s
    contraction dim (an FSDP weight met by data-parallel rows)."""
    from torch.distributed.tensor import Shard
    return any(a == Shard(0) and b == Shard(0)
               for a, b in zip(h.placements, w.placements))


def _out_region(real, used):
    def _out(self, t, w):
        if not _decoding(t):
            return real(self, t, w)
        used.add("decode")
        return _dot(t, w)
    return _out


def _swiglu_region(real, used):
    def swiglu(x, w_gate, w_up, w_down):
        if not _decoding(x):
            return real(x, w_gate, w_up, w_down)
        import torch.nn.functional as F
        used.add("decode")
        return _dot(F.silu(_column_product(x, w_gate))
                    * _column_product(x, w_up), w_down)
    return swiglu


def _chunked_region(real, used):
    def chunked_attention(q, k, v, **kw):
        if _decoding(q):     # attention's placements reached explicitly
            qpl, kpl, _ = fa.shard_rule(q, k)
            used.add("decode")
            q, k, v = (_redistribute(t, pl)
                       for t, pl in ((q, qpl), (k, kpl), (v, kpl)))
        return real(q, k, v, **kw)
    return chunked_attention


def _decode_region(real, used):
    def decode_step(self, cache, tokens):
        if not _is_dtensor(tokens):
            return real(self, cache, tokens)
        used.add("decode")
        con = self.constrain
        if con is not None:          # JAX's constraints, explicitly

            def explicit(x, axes):
                if not _is_dtensor(x):
                    return con(x, axes)
                return _redistribute(x, _placements(x.device_mesh, x.shape,
                                                    axes))
            explicit.mesh = con.mesh
            self.constrain = explicit
        _DECODE.on, _DECODE.memo = True, {}
        try:
            return real(self, cache, tokens)
        finally:
            _DECODE.on, _DECODE.memo = False, {}
            self.constrain = con
    return decode_step


def _whole_heads(t, heads):
    """``t``'s placements (B, S, heads * d_head) with the columns gathered
    on each mesh dim that does not divide ``heads``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    return [Replicate() if p == Shard(2) and heads % mesh.size(i) else p
            for i, p in enumerate(t.placements)]


class _WholeHeadsGrad(torch.autograd.Function):
    """The identity on a merged attention output (B, S, heads * d_head);
    its gradient's columns gathered on each mesh dim that does not divide
    the heads before the merge's backward splits them."""

    @staticmethod
    def forward(ctx, t, heads):
        ctx.heads = heads
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _redistribute(g, _whole_heads(g, ctx.heads)), None


class _UnitDimGrad(torch.autograd.Function):
    """The identity on split heads (B, S, heads, d_head); its gradient's
    heads dim replicated on each mesh dim of size 1 that shards it (no
    collective: such a dim holds the whole tensor), since DTensor refuses
    to merge a sharded dim of size 1 (one KV head) back into the
    columns."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate, Shard
        mesh = g.device_mesh
        return g.redistribute(mesh, [
            Replicate() if p == Shard(2) and mesh.size(i) == 1 else p
            for i, p in enumerate(g.placements)])


class _SplitHeads(torch.autograd.Function):
    """``split(t, heads)``, the model's head split of ``t`` (B, S, heads *
    d_head), whose columns are whole or a whole number of heads a shard;
    its gradient merged back on each rank's shard, its partial sums kept
    for the columns' own reduction (``_DataGather``). DTensor's view of a
    partial gradient reduce-scatters it over the batch and gathers it back
    (torch 2.13), where 2.11 keeps it partial."""

    @staticmethod
    def forward(ctx, t, heads, split):
        ctx.pl, ctx.shape, ctx.stride = list(t.placements), t.shape, \
            t.stride()
        return split(t, heads)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        want = [p if p.is_partial() else q
                for p, q in zip(g.placements, ctx.pl)]
        g = _redistribute(g, want)
        local = g.to_local()
        return DTensor.from_local(
            local.reshape(*local.shape[:2], -1), g.device_mesh, want,
            run_check=False, shape=ctx.shape, stride=ctx.stride), None, None


def _heads_region(real, used):
    def _split_heads(self, t, heads):
        if not _is_dtensor(t):
            return real(self, t, heads)
        pl = _whole_heads(t, heads)
        if pl != list(t.placements):
            used.add("split_heads")
            t = _DataGather.apply(t, pl)
        out = _SplitHeads.apply(t, heads, functools.partial(real, self))
        if heads == 1 and out.requires_grad and 1 in t.device_mesh.shape:
            used.add("split_heads")
            out = _UnitDimGrad.apply(out)
        return out
    return _split_heads


def _merge_region(real, used):
    def _merge_heads(self, t):
        out = real(self, t)
        heads = t.shape[1]
        if _is_dtensor(out) and out.requires_grad and any(
                heads % n for n in out.device_mesh.shape):
            used.add("split_heads")
            out = _WholeHeadsGrad.apply(out, heads)
        return out
    return _merge_heads


def _store_region(real, used):
    def _store(self, cache, slot, new):
        from torch.distributed.tensor import Replicate, Shard
        if not _is_dtensor(cache):
            return real(self, cache, slot, new)
        used.add("cache_store")
        mesh = cache.device_mesh
        seq = [i for i, pl in enumerate(cache.placements) if pl == Shard(2)]
        # new (B, Hkv, D) laid out as the cache's batch, heads and head_dim
        pl = [Replicate() if p == Shard(2) else Shard(2) if p == Shard(3)
              else p for p in cache.placements]
        local = cache.to_local()
        val = _redistribute(_cut_first(new, pl), pl).to_local()
        at = slot - _offset(mesh, seq, local.shape[2])
        if 0 <= at < local.shape[2]:          # the rank that holds the slot
            real(self, local, at, val)
    return _store


def _nll_region(real, used):
    def _nll(self, logits, labels):
        if not _is_dtensor(logits):
            return real(self, logits, labels)
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        used.add("loss")
        mesh = logits.device_mesh
        lpl = _placements(mesh, logits.shape, ("data", None, "model"))
        rows = [pl if pl == Shard(0) else Replicate() for pl in lpl]
        vocab = [i for i, pl in enumerate(lpl) if pl == Shard(2)]

        def local(z, labels):   # the log-sum-exp and gold over vocab shards
            V = z.shape[-1]
            z32 = z.float()
            m = z32.detach().amax(dim=-1, keepdim=True)
            for i in vocab:
                m = funcol.all_reduce(m, "max", (mesh, i))
            se = torch.exp(z32 - m).sum(dim=-1)
            idx = labels - _offset(mesh, vocab, V)
            inside = (idx >= 0) & (idx < V)
            gold = torch.gather(z, -1, idx.clamp(0, V - 1)[..., None])[..., 0]
            gold = gold.float() * inside
            for i in vocab:
                se, gold = _sum(se, mesh, i), _sum(gold, mesh, i)
            return torch.log(se) + m[..., 0] - gold

        return local_map(local, out_placements=rows,
                         in_placements=(lpl, rows), device_mesh=mesh,
                         redistribute_inputs=True)(logits, labels)
    return _nll


def _ssm_decode_region(real, used):
    def mamba2_decode_step(x_t, p, cfg, state):
        if not _is_dtensor(x_t):
            return real(x_t, p, cfg, state)
        used.add("mamba2_decode_step")
        return _ssm_decode(x_t, p, cfg, state)
    return mamba2_decode_step


def _ssm_decode(x_t, p, cfg, state):
    """``mamba2_decode_step`` with the mixer's weights in their stored
    shards: ``in_proj``'s contraction split over the data dims (x_t's d
    shard, ``_meet``), its partial columns reduced once and gathered whole
    (``_settle``); the conv on this rank's channels of ``conv_w`` and of
    the cache's window, its outputs gathered whole over "model"; the state
    stepped on the cache's heads (``cache_pspecs``), the gated norm's mean
    over those heads' channels summed over "model"; ``out_proj``
    row-parallel, its output a partial sum for ``_residual`` to reduce.
    The state and window come back in the cache's layout. The arithmetic
    is ``mamba2_decode_step``'s, each step on the rank's slice."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_d_state, \
        cfg.ssm_n_groups
    d_in = cfg.d_inner
    conv_ch = d_in + 2 * G * N
    zx = _dot(x_t, p["in_proj"])              # (B, 1, 2 d_in + 2 G N + H)
    mesh = zx.device_mesh
    zx = _settle(zx, [Replicate() if a == Shard(2) else a
                      for a in _columns(x_t, zx)])
    ch = [i for i, a in enumerate(p["conv_w"].placements) if a == Shard(1)]
    heads = [i for i, a in enumerate(state.state.placements) if a == Shard(1)]
    ch_pl = [Shard(0) if i in ch else Replicate() for i in range(mesh.ndim)]
    h_pl = [Shard(0) if i in heads else Replicate()
            for i in range(mesh.ndim)]
    y_pl = [Shard(2) if i in heads else a if a == Shard(0) else Replicate()
            for i, a in enumerate(zx.placements)]
    small = {"conv_b": ch_pl, "A_log": h_pl, "D": h_pl, "dt_bias": h_pl,
             "norm": h_pl}
    ws = {k: _redistribute(p[k], pl) for k, pl in small.items()}

    def local(zx, conv_w, conv_b, A_log, D, dt_bias, norm, st, conv):
        B, dtype = zx.shape[0], zx.dtype
        z, xBC, dt = torch.split(zx[:, 0], [d_in, conv_ch, H], dim=-1)
        c0 = _offset(mesh, ch, conv_w.shape[1])
        xBC = xBC[:, c0:c0 + conv_w.shape[1]]
        win = torch.cat([conv.to(dtype), xBC[:, None, :]], dim=1)
        xBC = F.silu(torch.einsum("bkc,kc->bc", win, conv_w) + conv_b)
        if ch:                      # every channel's conv output, whole
            xBC = _gather_last(xBC, mesh, ch)
        x_in, B_, C_ = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
        Hl = st.shape[1]
        h0 = _offset(mesh, heads, Hl)
        x_in = x_in.reshape(B, H, P)[:, h0:h0 + Hl]
        B_ = mamba2._expand_groups(B_.reshape(B, 1, G, N), H)[:, 0,
                                                                h0:h0 + Hl]
        C_ = mamba2._expand_groups(C_.reshape(B, 1, G, N), H)[:, 0,
                                                                h0:h0 + Hl]
        dt = mamba2._softplus(dt.float()[:, h0:h0 + Hl] + dt_bias)
        decay = torch.exp(-torch.exp(A_log.float()) * dt)
        x_dt = x_in.float() * dt[..., None]
        s = st * decay[:, :, None, None] \
            + B_.float()[..., :, None] * x_dt[..., None, :]
        y = (C_.float()[..., None, :] @ s)[..., 0, :]
        y = (y + D[:, None] * x_in.float()).reshape(B, Hl * P).to(dtype)
        # the gated norm over the heads' channels here, its mean's sum
        # over the heads' shards
        g = y * F.silu(z[:, h0 * P:(h0 + Hl) * P])
        g32 = g.float()
        var = _psum((g32 * g32).sum(dim=-1, keepdim=True), mesh, heads) \
            / d_in
        g = (g32 * torch.rsqrt(var + cfg.norm_eps)).to(dtype) * norm
        return g[:, None, :], s, win[:, 1:, :]

    st_pl, cv_pl = list(state.state.placements), list(state.conv.placements)
    g, st, conv = local_map(
        local, out_placements=(y_pl, st_pl, cv_pl),
        in_placements=(list(zx.placements), list(p["conv_w"].placements))
        + tuple(small.values()) + (st_pl, cv_pl), device_mesh=mesh)(
        zx, p["conv_w"], *ws.values(), state.state, state.conv)
    return _dot(g, p["out_proj"]), mamba2.SSMState(state=st, conv=conv)


def _gather_last(t, mesh, dims):
    """``t``, a local tensor, gathered whole along its last dim over
    ``mesh``'s dims ``dims`` (major first), one collective."""
    import torch.distributed._functional_collectives as funcol
    out = funcol.all_gather_tensor(t.contiguous(), t.dim() - 1,
                                   _group(mesh, dims))
    return out.wait() if hasattr(out, "wait") else out


#: where each region stands in: (module or class, attribute, region)
_SITES = ((moe, "moe_ffn", _moe_region),
          (moe, "moe_ffn_shard_map", _shard_map_region),
          (mamba2, "mamba2_mixer", _mixer_region),
          (mamba2, "_split_columns", _columns_region),
          (mamba2, "_skip", _skip_region),
          (mamba2, "_gated_norm_out", _gated_norm_region),
          (mamba2, "_mean_last", _mean_last_region),
          (mamba2, "ssd_chunked", _ssd_region),
          (mamba2, "mamba2_decode_step", _ssm_decode_region),
          (L, "decode_attention", _decode_attention_region),
          (L, "gelu_mlp", _gelu_region),
          (L, "swiglu", _swiglu_region),
          (L, "chunked_attention", _chunked_region),
          (LM, "_lookup", _lookup_region),
          (LM, "_nll", _nll_region),
          (LM, "_store", _store_region),
          (LM, "_split_heads", _heads_region),
          (LM, "_merge_heads", _merge_region),
          (LM, "_residual", _residual_region),
          (LM, "_carry", _carry_region),
          (LM, "_proj", _proj_region),
          (LM, "_out", _out_region),
          (LM, "decode_step", _decode_region),
          (LM, "_norm", _norm_region),
          (LM, "_qk_norm", _qk_norm_region),
          (LM, "_gather_weights", _wgather_region),
          (lm_step, "_grad", _grad_region),
          (lm_step, "_add_sq", _add_sq_region),
          (lm_step, "_grad_norm", _grad_norm_region),
          (O, "factored_means", _moments_region),
          (O, "factored_moment", _moment_region),
          (O, "factored_scale", _scale_region))


@contextlib.contextmanager
def regions(used: set):
    """The functions of ``REGIONS`` replaced, for the duration, by wrappers
    that run them on DTensors' local shards under ``local_map`` (plain
    tensors pass through to the function itself); ``used`` collects the
    regions a run took."""
    real = [getattr(owner, name) for owner, name, _ in _SITES]
    for (owner, name, region), fn in zip(_SITES, real):
        setattr(owner, name, region(fn, used))
    try:
        yield
    finally:
        for (owner, name, _), fn in zip(_SITES, real):
            setattr(owner, name, fn)


@contextlib.contextmanager
def mesh_arithmetic_outside_the_modes():
    """``_StridedShard`` (torch 2.13) finds a shard's offsets from an
    ``arange`` it makes and reads back (``.tolist()``); under the fake mode
    that tensor is fake and the read fails (``aten._local_scalar_dense``).
    Its integers come from the mesh, not the data: for the duration that
    method runs with the dispatch modes (the fake mode, the counters) set
    aside. Where torch has no such method, nothing changes."""
    from torch.distributed.tensor import placement_types as PT
    from torch.utils._python_dispatch import _disable_current_modes
    cls = getattr(PT, "_StridedShard", None)
    real = getattr(cls, "__dict__", {}).get("local_shard_size_and_offset")
    if real is None:
        yield
        return

    @functools.wraps(real)
    def offsets(*args, **kw):
        with _disable_current_modes():
            return real(*args, **kw)
    cls.local_shard_size_and_offset = offsets
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = real


# ---------------------------------------------------------------- cells
def fake_dtensor(fake_mode, mesh, shape, dtype, s, device_type: str):
    """A ``DTensor`` of global ``shape`` laid out by spec ``s`` on
    ``mesh``, its local shard a fake tensor on ``device_type``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = SH.to_placements(mesh, s)
    local, _ = compute_local_shape_and_global_offset(tuple(shape), mesh, pl)
    with fake_mode:
        t = torch.empty(local, dtype=dtype, device=device_type)
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def shard_lm(lm: LM, mesh, make: Callable, *, fsdp: bool = True,
             fsdp_mode: str = "hidden") -> dict:
    """Lay ``lm``'s parameters out on ``mesh`` by ``param_pspecs``: each of
    JAX's leaves becomes ``make(leaf, spec)`` (a ``DTensor``), stored
    where the leaf was (``lm.top``, ``lm.stacked``), and each per-period
    parameter becomes slice p of its stacked ``DTensor``, as ``LM``
    builds it. Returns the leaves by path (the step's parameter
    argument). On a stacked dim sharded over the data axes DTensor's
    select gathers the period and returns a copy, not a view
    (``copied_leaves``)."""
    from torch import nn
    tree = {g.path: g.leaf for g in leaf_groups(lm)}
    specs = SH.param_pspecs(mesh, tree, fsdp=fsdp, fsdp_mode=fsdp_mode)
    out = {}
    for path, leaf in tree.items():
        D = make(leaf, specs[path])
        out[path] = D
        if path in lm.stacked:
            lm.stacked[path] = D
            tree_name, key, name = path.split("/")
            blocks = lm.layers if tree_name == "blocks" else lm.encoder
            for i, blk in enumerate(blocks):
                blk[key][name] = nn.Parameter(D[i], requires_grad=False)
        else:
            lm.top[path] = nn.Parameter(D, requires_grad=False)
    return out


def copied_leaves(lm: LM) -> list:
    """The stacked leaves whose per-period parameters are copies, not views
    of them (``LeafGroup.views``): DTensor's select on a period dim sharded
    over the data axes (``fsdp_mode="stack"``, or a 2-D norm scale whose
    period count divides them, as JAX's rules lay it out) all-gathers the
    period into a copy. The train step updates such a leaf itself, and
    ``with_copies`` gathers its periods before each step."""
    return [g for g in leaf_groups(lm) if g.stacked and not g.views]


def with_copies(step, copies, once: bool = False):
    """``step`` after the gathers of the copied periods from their stacked
    leaves (``copied_leaves``): the collectives JAX's scan over a sharded
    stack pays inside its step. A train step updates the stacked leaf
    itself, so each call reads the periods of the last update; each
    period's select gathers the leaf. With ``once`` (a decode step) each
    leaf is gathered once, over the data dims (``_redistribute``), and its
    periods are cut from it, as JAX gathers the stacked leaf once."""
    if not copies:
        return step

    def run(*args, **kw):
        with torch.no_grad():
            for g in copies:
                leaf = g.leaf
                if once:
                    leaf = _redistribute(leaf, _dp_replicated(
                        leaf.device_mesh, leaf.placements))
                for i, t in enumerate(g.tensors):
                    t.copy_(leaf[i])
        return step(*args, **kw)
    return run


def place_step(lm: LM, mesh, kind: str, trees: dict, make: Callable,
               variant: str = "baseline", *,
               optimizer: O.Optimizer | None = None):
    """The port's own step of a cell of ``kind`` ("train", "prefill",
    "decode") over ``lm`` and ``trees`` laid out on ``mesh`` by the
    variant's rules, with the mesh's constrainer: each tensor of ``lm``'s
    parameters (``param_pspecs``) and of ``trees`` (``batch``, and ``opt``
    (``param_pspecs``) to train; ``cache`` (``cache_pspecs``) and ``tokens``
    to decode) becomes ``make(tensor, spec)``, a
    ``DTensor`` (fake in ``build_cell``, a real one's shards in a test);
    Python ints stay as they are. -> (the step with no arguments, its
    arguments by name, ``copied_leaves``)."""
    var = VARIANTS[variant]
    fsdp = var.get("fsdp", True)
    fsdp_mode = var.get("fsdp_mode", "hidden")
    lm.constrain = SH.make_constrainer(mesh)
    params = shard_lm(lm, mesh, make, fsdp=fsdp, fsdp_mode=fsdp_mode)
    copies = copied_leaves(lm)

    def lay(tree, specs):
        return _map_tree(lambda path, t: make(t, specs[path])
                         if isinstance(t, torch.Tensor) and t.dim() else t,
                         tree)

    def batch_of(tree):
        return lay(tree, SH.flatten(SH.batch_pspec(mesh, tree)))

    if kind == "train":
        opt_state = lay(trees["opt"], SH.flatten(SH.param_pspecs(
            mesh, trees["opt"], fsdp=var.get("opt_fsdp", fsdp),
            fsdp_mode=fsdp_mode)))
        batch = batch_of(trees["batch"])
        step = with_copies(lm_step.make_train_step(lm, optimizer), copies)
        return (lambda: step(opt_state, batch)), {
            "params": params, "opt": opt_state, "batch": batch}, copies
    if kind == "prefill":
        batch = batch_of(trees["batch"])
        prefill = with_copies(lm_step.make_prefill_step(lm), copies)
        return (lambda: prefill(**batch)), {
            "params": params, "batch": batch}, copies
    cache = lay(trees["cache"], SH.flatten(SH.cache_pspecs(
        mesh, trees["cache"], seq_shard=var.get("kv_seq_shard", False))))
    tokens = batch_of({"tokens": trees["tokens"]})["tokens"]
    serve = with_copies(lm_step.make_serve_step(lm), copies, once=True)
    # the cache's length runs as the host int the port reads (0 for the
    # int32 scalar JAX passes, which is what is counted)
    length = cache["len"]
    run_cache = {"blocks": cache["blocks"],
                 "len": length if isinstance(length, int) else 0}
    return (lambda: serve(run_cache, tokens)), {
        "params": params, "cache": cache, "tokens": tokens}, copies


def _map_tree(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn("/".join(path), tree)


def no_effect(cfg: ArchConfig) -> list[str]:
    """The configuration fields the port lacks, with what they would
    steer under JAX."""
    out = []
    if cfg.attn_gqa_mode != "grouped":
        out.append(f"attn_gqa_mode={cfg.attn_gqa_mode}: the port has one "
                   "attention (kernel 8 reads each KV head's group in "
                   "place); JAX's 'repeat' layout has no counterpart")
    if cfg.n_experts and cfg.moe_buf_mode != "shard_map":
        out.append(f"moe_buf_mode={cfg.moe_buf_mode}: the dispatch runs in "
                   "the moe_ffn region on each rank's rows and experts; "
                   "JAX's buffer layouts have no counterpart there")
    return out


@dataclasses.dataclass
class Cell:
    """A built cell: its step ``fn`` (no arguments) over ``args``, laid
    out on ``mesh``, to run under ``fake_mode``."""
    arch: str
    cfg: ArchConfig
    cell: shp.ShapeCell
    mesh: Any
    fn: Callable
    args: dict
    fake_mode: Any
    lm: LM
    copies: list
    no_effect: list


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: str = "baseline", *, cfg: ArchConfig | None = None,
               cell: shp.ShapeCell | None = None, device_type: str = "cuda",
               mesh_shape: tuple | None = None,
               dtype: torch.dtype = torch.bfloat16) -> Cell:
    """The cell's step on fake tensors. ``cfg`` and ``cell`` replace the
    arch's config (before the variant's changes) and the shape's cell (a
    depth cut, an off-grid shape), ``mesh_shape`` the mesh's (JAX's
    variants' own, or a test's), ``dtype`` the parameters' and the
    frontend inputs' (JAX's dry-run's bf16; the optimiser is the config's
    at 3e-4). Initialises the fake process group at the mesh's size when
    no group exists; ``run_cell`` destroys it."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device_type 'cuda' requested but CUDA is not available; pass "
            "device_type='cpu' (--device cpu) to run the dry-run on the CPU")
    _quiet()
    var = VARIANTS[variant]
    cfg = cfg if cfg is not None else get_config(arch)
    if var.get("cfg"):
        cfg = dataclasses.replace(cfg, **var["cfg"])
    cell = cell or shp.SHAPES[shape_name]
    shape = tuple(mesh_shape or var.get("mesh_shape") or (16, 16))
    if multi_pod:
        shape = (2,) + shape
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(torch.Size(shape).numel()))
    mesh = build_mesh(shape, axes, device_type=device_type)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)

    lm = LM(cfg, dtype=dtype, device="meta")
    opt = None
    if cell.kind == "train":
        opt = O.get(cfg.optimizer, 3e-4)
        trees = {"batch": SP.train_batch_specs(cfg, shape_name, cell),
                 "opt": opt.init({g.path: g.leaf for g in leaf_groups(lm)})}
    elif cell.kind == "prefill":
        trees = {"batch": SP.prefill_specs(cfg, shape_name, cell)}
    else:
        trees = SP.decode_specs(cfg, shape_name, lm, cell=cell)
    if "batch" in trees:             # the frontend inputs in the model's
        trees["batch"] = {k: v.to(dtype) if v.is_floating_point() else v
                          for k, v in trees["batch"].items()}

    def make(t, s):
        return fake_dtensor(fake_mode, mesh, t.shape, t.dtype, s, device_type)
    fn, args, copies = place_step(lm, mesh, cell.kind, trees, make, variant,
                                  optimizer=opt)
    return Cell(arch, cfg, cell, mesh, fn, args, fake_mode, lm,
                copies, no_effect(cfg))


@dataclasses.dataclass
class Run:
    """What running a cell's step on the fake tensors read."""
    arg_bytes: int
    out_bytes: int
    temp_bytes: int
    coll_by_kind: dict
    comms: dict
    calls: list
    comm_counts: dict
    local_regions: list
    run_s: float
    out: Any = None


def run_step(c: Cell) -> Run:
    """``c.fn`` once under the fake mode, ``implicit_replication``, the
    regions, ``CommDebugMode`` and a ``Recorder``."""
    from torch.distributed.tensor.experimental import implicit_replication
    rec = Recorder()
    rec.exclude(c.args)
    rec.exclude([p for p in c.lm.parameters()])
    used: set = set()
    t0 = time.perf_counter()
    with mesh_arithmetic_outside_the_modes(), c.fake_mode, \
            implicit_replication(), regions(used), counting(rec) as cm:
        out = c.fn()
    run_s = time.perf_counter() - t0
    out_bytes = rec.new_bytes(out)
    # the copied periods live through the step (made at build, refilled
    # by its gathers)
    copied = sum(_nbytes(t) for g in c.copies for t in g.tensors)
    return Run(arg_bytes=tree_bytes(c.args), out_bytes=out_bytes,
               temp_bytes=max(rec.peak - out_bytes, 0) + copied,
               coll_by_kind=rec.by_kind(),
               comms={k: v[:] for k, v in rec.comms.items()},
               calls=list(rec.calls), comm_counts=comm_counts(cm),
               local_regions=[REGIONS[r] for r in sorted(used)],
               run_s=run_s, out=out)


def _stem(arch: str, shape_name: str, mesh_name: str, variant: str) -> str:
    stem = f"{arch.replace('.', '_')}__{shape_name}__{mesh_name}"
    return stem if variant == "baseline" else stem + f"__{variant}"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = "results/dryrun_torch",
             variant: str = "baseline", *, cfg: ArchConfig | None = None,
             cell: shp.ShapeCell | None = None, device_type: str = "cuda",
             mesh_shape: tuple | None = None,
             dtype: torch.dtype = torch.bfloat16, write: bool = True) -> dict:
    """One cell: JAX's skip, ``build_cell``, ``run_step``, the roofline,
    and the record (written under JAX's stem with ``write``). The fake
    group is created here and destroyed before this returns."""
    import torch.distributed as dist
    mesh_name = "multi" if multi_pod else "single"
    base = cfg if cfg is not None else get_config(arch)
    runs, why = shp.applicable(base, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant}
    if not runs:
        rec.update(status="skipped", reason=why)
        if write:
            os.makedirs(out_dir, exist_ok=True)
            fname = f"{arch.replace('.', '_')}__{shape_name}__{mesh_name}" \
                    ".json"
            with open(os.path.join(out_dir, fname), "w") as f:
                json.dump(rec, f, indent=1)
        return rec
    try:
        t0 = time.perf_counter()
        c = build_cell(arch, shape_name, multi_pod, variant, cfg=cfg,
                       cell=cell, device_type=device_type,
                       mesh_shape=mesh_shape, dtype=dtype)
        t_lower = time.perf_counter() - t0
        r = run_step(c)
        chips = int(c.mesh.size())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    rl = RL.analyze(arch=arch, shape=c.cell.name, mesh_name=mesh_name,
                    chips=chips, cfg=c.cfg, cell=c.cell,
                    coll_by_kind=r.coll_by_kind)
    mem = {"argument_size_in_bytes": r.arg_bytes,
           "output_size_in_bytes": r.out_bytes,
           "temp_size_in_bytes": r.temp_bytes,
           "generated_code_size_in_bytes": 0}
    total = r.arg_bytes + r.out_bytes + r.temp_bytes
    rec.update(
        status="ok", chips=chips,
        lower_s=round(t_lower, 1), compile_s=round(r.run_s, 1),
        flops_per_chip=rl.flops_per_chip, bytes_per_chip=rl.bytes_per_chip,
        raw_hlo_flops=rl.raw_hlo_flops, raw_hlo_bytes=rl.raw_hlo_bytes,
        coll_bytes=rl.coll_bytes, coll_by_kind=rl.coll_by_kind,
        model_flops=rl.model_flops, compute_s=rl.compute_s,
        memory_s=rl.memory_s, collective_s=rl.collective_s,
        bottleneck=rl.bottleneck, useful_ratio=rl.useful_ratio,
        step_s=rl.step_s, mfu=rl.mfu, memory_analysis=mem,
        collectives_from="CommDebugMode", comm_counts=r.comm_counts,
        comms=r.comms,
        fits=total <= H100.hbm_bytes, hbm_bytes=H100.hbm_bytes,
        local_regions=r.local_regions, no_effect=c.no_effect,
        copied_leaves=[g.path for g in c.copies], device_type=device_type,
        generated_code_note="nothing is compiled: the kernels are built "
                            "once per process, outside the step")
    if write:
        os.makedirs(out_dir, exist_ok=True)
        stem = _stem(arch, shape_name, mesh_name, variant)
        with open(os.path.join(out_dir, stem + ".json"), "w") as f:
            json.dump(rec, f, indent=1, default=float)
        comms_dir = os.path.join(out_dir, "comms")
        os.makedirs(comms_dir, exist_ok=True)
        with open(os.path.join(comms_dir, stem + ".json"), "w") as f:
            json.dump({"comm_counts": r.comm_counts, "comms": r.comms}, f,
                      indent=1)
    print(rl.row())
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (assignment name)")
    ap.add_argument("--shape", default=None, choices=list(shp.SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose result JSON already exists")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' and the mesh's device type: "
                         "cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.all:
        ok = failed = skipped = 0
        for arch in ALIASES:
            for shape_name in shp.SHAPES:
                for mesh_name in ("single", "multi"):
                    fname = os.path.join(
                        args.out, f"{arch.replace('.', '_')}__{shape_name}"
                        f"__{mesh_name}.json")
                    if args.resume and os.path.exists(fname):
                        ok += 1
                        continue
                    t0 = time.perf_counter()
                    try:
                        rec = run_cell(arch, shape_name, mesh_name == "multi",
                                       args.out, device_type=args.device)
                        if rec["status"] == "ok":
                            ok += 1
                        else:
                            skipped += 1
                        print(f"[dryrun] {arch} {shape_name} {mesh_name}: "
                              f"{rec['status']} in "
                              f"{time.perf_counter() - t0:.1f} s", flush=True)
                    except Exception:
                        failed += 1
                        traceback.print_exc()
                        print(f"[dryrun] {arch} {shape_name} {mesh_name}: "
                              f"failed in {time.perf_counter() - t0:.1f} s",
                              flush=True)
        print(f"dry-run sweep: ok={ok} skipped={skipped} failed={failed}")
        raise SystemExit(1 if failed else 0)

    rec = run_cell(args.arch, args.shape, args.mesh == "multi", args.out,
                   variant=args.variant, device_type=args.device)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("coll_by_kind", "memory_analysis",
                                   "comm_counts")},
                     indent=1, default=float))


if __name__ == "__main__":
    main()
