"""One rank of the port's sharded steps run for real on gloo:

    python tests/_torch_dryrun_gloo.py DIR RANK WORLD

Four ranks (WORLD 4) join a gloo group through a file in DIR and build the
meshes (data 2, model 2) and (data 4, model 1) of the cells on the CPU,
and (pod 2, data 2, model 1) for ``dryrun._redistribute``'s collectives
over two data dims (``flat_collectives``). For each cell of ``CELLS`` every rank
draws the reduced config in float32 from seed 0 and its inputs from
``RandomState(0)``, runs the unsharded port, then lays a second model of
the same seed (the variant's configuration changes applied) and the same
inputs out as the dry-run does
(``launch.dryrun.place_step`` over ``distribute_tensor``) and runs the
step once under ``implicit_replication``, the dry-run's regions,
``CommDebugMode`` and its recorder: the cell ``_torch_dryrun_fake.py``
runs on fake tensors. It writes, a cell each, the count, the bytes by op,
the regions taken and the largest differences from the unsharded run to
``DIR/rank{RANK}.json``:

  * prefill cells: the gathered logits, and the forward's aux loss;
  * the train cell (``stack_wgather``: every stacked leaf's periods are
    copies, each sublayer's weights gathered at use) and one of each other
    family: the loss, the gradient norm,
    every parameter leaf and every tensor of the optimiser's state after
    the step;
  * decode cells (a cache of 64 filled to ``DECODE_LEN`` by the unsharded
    model): the logits, and the cache after the step. The fake group runs
    them on an empty cache: the collectives do not depend on its length.
"""

import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

#: (name, arch, kind, variant, (B, S)): the cells, each also in
#: ``_torch_dryrun_fake.py``
CELLS = (("prefill", "yi-6b", "prefill", "baseline", (4, 32)),
         ("train", "yi-6b", "train", "stack_wgather", (4, 32)),
         ("decode", "yi-6b", "decode", "baseline", (4, 64)),
         ("decode_seqshard", "yi-6b", "decode", "kv_seqshard", (4, 64)),
         ("moe", "qwen3-moe-235b-a22b", "prefill", "baseline", (4, 32)),
         ("moe_shmap", "qwen3-moe-235b-a22b", "prefill", "moe_shmap",
          (4, 32)),
         ("ssm", "mamba2-780m", "prefill", "baseline", (4, 32)),
         ("ssm_decode", "mamba2-780m", "decode", "baseline", (4, 64)),
         ("gelu", "whisper-tiny", "prefill", "baseline", (4, 32)),
         ("moe_train", "qwen3-moe-235b-a22b", "train", "baseline", (4, 32)),
         ("ssm_train", "mamba2-780m", "train", "baseline", (4, 32)),
         ("gelu_train", "whisper-tiny", "train", "baseline", (4, 32)),
         ("one_kv_train", "yi-6b", "train", "baseline", (4, 32)),
         ("hybrid_decode", "jamba-1.5-large-398b", "decode", "baseline",
          (1, 64)))
#: the (data, model) mesh of a cell, (2, 2) unless named here: (4, 1) for
#: the reduced Yi-6B's one KV head "split" over a model dim of 1
MESHES = {"one_kv_train": (4, 1)}


def mesh_of(name) -> tuple:
    return MESHES.get(name, (2, 2))


def flat_collectives(mesh, rank) -> dict:
    """``dryrun._redistribute`` on (pod 2, data 2, model 1) against
    DTensor's own redistribution of the same tensor (a dim over "pod"
    then "data"): the gather of a tensor sharded over both data dims (on
    dim 0 and dim 1), the reduce-scatter of one partial over both (dim 0
    and 1) and its all-reduce; and the gather of a shard over "model", a
    dim of one rank. -> {case: {"err": largest difference of
    this rank's shard, "comms": the recorder's collectives of
    ``_redistribute``, "placements": equal}}"""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    from repro_torch.launch import dryrun as DR
    full = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (8, 12)).astype(np.float32))
    rep = [Replicate()] * 3
    out = {}
    cases = [(f"gather{d}", [Shard(d), Shard(d), Replicate()], rep)
             for d in (0, 1)]
    cases += [(f"scatter{d}", [Partial(), Partial(), Replicate()],
               [Shard(d), Shard(d), Replicate()]) for d in (0, 1)]
    cases += [("reduce", [Partial(), Partial(), Replicate()], rep)]
    # over "model", one rank: the whole tensor is there, nothing moves
    cases += [("one_rank", [Replicate(), Replicate(), Shard(1)], rep)]
    for name, src, dst in cases:
        if src[0] == Partial():         # each rank's term of the sum
            t = DTensor.from_local(full * (rank + 1), mesh, src)
        else:
            t = distribute_tensor(full, mesh, src)
        want = t.redistribute(mesh, dst)
        rec = DR.Recorder()
        with DR.counting(rec):
            got = DR._redistribute(t, dst)
        out[name] = {"err": _err(got.to_local(), want.to_local()),
                     "comms": rec.comms,
                     "placements": list(got.placements) == list(dst)}
    return out
#: the tokens a decode cell's cache holds before its step
DECODE_LEN = 40


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _err(got, want) -> float:
    return float((_full(got).float() - want.float()).abs().max())


def real_inputs(tree, cfg, rng):
    """Each meta tensor of ``tree`` drawn: ints as tokens, floats as
    frontend embeddings in float32."""
    if isinstance(tree, dict):
        return {k: real_inputs(v, cfg, rng) for k, v in tree.items()}
    if tree.dtype == torch.int32:
        return torch.from_numpy(rng.randint(0, cfg.vocab, tuple(tree.shape))
                                .astype(np.int32))
    return torch.from_numpy(
        rng.standard_normal(tuple(tree.shape)).astype(np.float32))


def run(name, arch, kind, variant, shape, mesh):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import specs as SP
    from repro_torch.models.model import LM
    from repro_torch.training import lm_step, optim as O

    cfg = dataclasses.replace(reduced(get_config(arch)),
                              **DR.VARIANTS[variant].get("cfg", {}))
    cell = ShapeCell(kind, shape[1], shape[0], kind)
    rng = np.random.RandomState(0)

    def model():
        lm = LM(cfg, dtype=torch.float32, device="cpu")
        return lm.init_params(torch.Generator().manual_seed(0))

    def place(t, s):
        return distribute_tensor(t, mesh, SH.to_placements(mesh, s))

    ref, lm = model(), model()
    res, opt = {}, None
    if kind == "train":
        opt = O.get(cfg.optimizer, 3e-4)
        batch = real_inputs(SP.train_batch_specs(cfg, kind, cell), cfg, rng)
        state = lm_step.make_opt_state(ref, opt)
        _, metrics = lm_step.make_train_step(ref, opt)(state, batch)
        trees = {"batch": batch, "opt": lm_step.make_opt_state(lm, opt)}
    elif kind == "prefill":
        batch = real_inputs(SP.prefill_specs(cfg, kind, cell), cfg, rng)
        with torch.no_grad():
            want, want_aux = ref.forward(**batch)
        trees = {"batch": batch}
    else:
        B, S = shape
        toks = real_inputs(SP.sds((B, DECODE_LEN + 1), torch.int32), cfg,
                           rng)
        _, cache = ref.prefill(toks[:, :DECODE_LEN], S)
        trees = {"cache": {"blocks": {k: {n: t.clone() for n, t in e.items()}
                                      for k, e in cache["blocks"].items()},
                           "len": cache["len"]},
                 "tokens": toks[:, DECODE_LEN:]}
        want, cache = ref.decode_step(cache, trees["tokens"])

    fn, args, copies = DR.place_step(lm, mesh, kind, trees, place, variant,
                                     optimizer=opt)
    rec, used = DR.Recorder(), set()
    with implicit_replication(), DR.regions(used), DR.counting(rec) as cm:
        got = fn()
    res.update(counts=DR.comm_counts(cm), comms=rec.comms,
               regions=sorted(used), copies=[g.path for g in copies])
    if kind == "train":
        _, got_metrics = got
        res["loss"] = _err(got_metrics["loss"], metrics["loss"])
        res["grad_norm"] = _err(got_metrics["grad_norm"],
                                metrics["grad_norm"])
        want_leaves, got_leaves = _leaves(ref), _leaves(lm)
        res["params"] = max(_err(got_leaves[p], t)
                            for p, t in want_leaves.items())
        res["moved"] = max(_err(t, want_leaves[p])
                           for p, t in _leaves(model()).items())
        got_state, want_state = _flat(args["opt"]), _flat(state)
        res["state"] = {p: _err(got_state[p], t)
                        for p, t in want_state.items() if p != "step"}
        res["state_max"] = max(float(t.abs().max())
                               for p, t in want_state.items() if p != "step")
        res["step"] = got_state["step"] == want_state["step"] == 1
    elif kind == "prefill":
        with torch.no_grad(), implicit_replication(), DR.regions(set()):
            _, aux = lm.forward(**args["batch"])
        res.update(logits=_err(got, want), max_abs=float(want.abs().max()),
                   aux=_err(aux, want_aux), aux_abs=float(want_aux.abs()),
                   shape=list(_full(got).shape))
    else:
        logits, _ = got
        res.update(logits=_err(logits, want),
                   max_abs=float(want.abs().max()),
                   cache=max(_err(args["cache"]["blocks"][k][n], t)
                             for k, e in cache["blocks"].items()
                             for n, t in e.items()))
    return res


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, path + (key,)).items()}
    return {"/".join(path): tree}


def _leaves(lm):
    from repro_torch.models.convert import leaf_groups
    return {g.path: g.leaf for g in leaf_groups(lm)}


def main() -> None:
    rdv, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_test_mesh

    DR._quiet()
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(rdv, "gloo"),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        meshes = {shape: make_test_mesh(shape, ("data", "model"),
                                        device_type="cpu")
                  for shape in sorted({mesh_of(c[0]) for c in CELLS})}
        res = {"rank": rank}
        for name, *cell in CELLS:
            res[name] = run(name, *cell, meshes[mesh_of(name)])
        res["flat"] = flat_collectives(make_test_mesh(
            (2, 2, 1), ("pod", "data", "model"), device_type="cpu"), rank)
        with open(os.path.join(rdv, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
