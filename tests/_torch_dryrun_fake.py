"""The port's dry-run on the fake process group, one process:

    python tests/_torch_dryrun_fake.py OUT_DIR jax|gloo|scale|b1
    python tests/_torch_dryrun_fake.py OUT_DIR sites ARCH SHAPE single|multi \
        VARIANT [cpu|cuda]

Every cell runs ``launch.dryrun.run_cell`` on ``"cpu"`` fake tensors, each
creating and destroying its own fake group. It prints one JSON object, of
the cells held to JAX's (``jax``: ``arguments``, ``shmap``, ``constrain``;
``b1``), to real gloo runs (``gloo``) or to each other (``scale``):

  * ``arguments``: per-rank ``argument_size_in_bytes`` of the reduced
    Yi-6B's train cell (8 x 32 tokens) and its decode cells (8 rows, a
    cache of 64; ``baseline`` and ``kv_seqshard``) on (pod 2, data 2,
    model 2), bf16 as JAX's dry-run; the train cell's record written to
    OUT_DIR;
  * ``collectives``: those cells' ``coll_by_kind`` and ``coll_bytes``
    (wire bytes) from their records;
  * ``shmap``: the reduced Qwen3-MoE's bf16 prefill (8 x 32) on that mesh
    under ``moe_shmap``: each c10d all-reduce's bytes, the MoE sublayers
    and the bytes one a sublayer should be;
  * ``gloo``: each cell ``_torch_dryrun_gloo.py`` runs for real (its
    ``CELLS``: reduced configs in float32 on (data 2, model 2)), here on
    the fake group: CommDebugMode's count, the recorder's bytes by op and
    the regions taken;
  * ``constrain``: ``make_constrainer`` on DTensors of that mesh, the
    placements it gave and those of ``to_placements(spec(...))``;
  * ``uneven_heads``: the reduced Qwen2.5-32B's and Whisper-tiny's bf16
    train cells on (data 2, model 3), whose model dim does not divide
    their 4 heads: status, wire bytes and the regions taken;
  * ``b1``: the decode cells of one row (``B1_CELLS``: the reduced Jamba,
    Mamba2 and Mixtral, one token against a cache of 64) on (pod 2,
    data 2, model 2), fewer rows than the data ranks: their
    ``arguments`` and ``collectives``, held to JAX's;
  * ``scale``: the reduced Qwen3-MoE's bf16 train cell (8 x 32) on
    (data 2, model 2) and on (pod 2, data 2, model 2), the same global
    batch: each one's per-rank temp and wire bytes (the second also as
    ``arguments`` and ``collectives``, held to JAX's); and the reduced
    Yi-6B's train cell (one KV head) on (data 2, model 1): its status
    and its collectives by call site (``one_kv``);
  * ``recorder``: whether the recorder's count equals CommDebugMode's in
    every cell;
  * ``sites``: the collectives of the tiny ``train`` (``baseline`` and
    ``wgather``), ``decode``, ``decode_seqshard``, ``moe_train``,
    ``one_kv`` and one-row decode cells and of each gloo cell
    (``gloo_<name>``) by call site (``Sites``);
  * ``peak``: the tiny ``train`` cell's live bytes by the line of the
    port that made them, at the recorder's peak and at each line's most
    (``Peak``).

The ``sites`` part runs one full-width cell on its production mesh and
writes its record to OUT_DIR; it prints the record's stem, the cell's
collectives by call site and its live bytes by line (``Peak``), as
``chip_smoke.py`` phase 6f reads them on the card.
"""

import collections
import contextlib
import json
import os
import sys

import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config, reduced
from repro_torch.configs.shapes import ShapeCell
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_dryrun_gloo import CELLS, mesh_of  # noqa: E402

TRAIN = ShapeCell("train_4k", 32, 8, "train")
DECODE = ShapeCell("decode_32k", 64, 8, "decode")
PREFILL = ShapeCell("prefill_32k", 32, 8, "prefill")
MESH3 = (2, 2)                      # with multi_pod: (pod 2, data 2, model 2)
#: train cells whose 4 heads the mesh's model dim (3) does not divide, as
#: 40 heads over 16 ranks at full width
UNEVEN_HEADS, UNEVEN_MESH = ("qwen2.5-32b", "whisper-tiny"), (2, 3)
#: (data 2, model 1): the reduced Yi-6B's one KV head "split" over it
ONE_KV_MESH = (2, 1)
#: the decode cells of one row: name -> arch, each one token against a
#: cache of 64 (``_torch_dryrun_jax.py``'s ``B1_ARCHS``)
B1_CELLS = {"decode_b1_hybrid": "jamba-1.5-large-398b",
            "decode_b1_ssm": "mamba2-780m",
            "decode_b1_moe": "mixtral-8x7b"}
DECODE_B1 = ShapeCell("long_500k", 64, 1, "decode")


#: the port's package: a collective's site is its innermost frame there
#: outside the dry-run itself
PORT = os.path.dirname(os.path.dirname(os.path.abspath(DR.__file__)))
DRYRUN = os.path.abspath(DR.__file__)


def _group(args) -> list:
    """The ranks of a collective's process group: a c10d op's group object,
    a functional op's group name (its last string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject):
            pg = torch._C._distributed_c10d.ProcessGroup.unbox(a)
            break
    else:
        pg = _resolve_process_group([a for a in args
                                     if isinstance(a, str)][-1])
    return dist.get_process_group_ranks(pg)


def _frame():
    """The innermost frame in the port's package outside
    ``launch/dryrun.py``; None for the autograd engine's own ops (a
    backward formula: torch 2.13 runs them under the frame that called
    ``backward()``, 2.11 on a thread with no Python frame)."""
    f = sys._getframe(2)
    while f is not None:
        name = os.path.abspath(f.f_code.co_filename)
        if name.startswith(PORT + os.sep) and name != DRYRUN:
            return f
        if f.f_code.co_name == "_engine_run_backward":
            break
        f = f.f_back
    return None


def _site() -> str:
    """``file:function`` of ``_frame()``; "-" for the engine's ops."""
    f = _frame()
    return "-" if f is None else \
        f"{os.path.relpath(f.f_code.co_filename, PORT)}:{f.f_code.co_name}"


class Sites:
    """Tags each collective the dry-run's ``Recorder`` counts, while
    installed (``with Sites() as s:``): its JAX kind, the mesh dims its
    group spans ("pod+data" for the two data dims flattened), its group
    size, its call site (``_site``), whether the backward issued it,
    whether DTensor issued it to pass a shard from one tensor dim to
    another (``shard_dim_alltoall``: an all-to-all on a card's mesh, an
    all-gather on a CPU mesh, so its kind reads "all-to-all" on both), its
    result's dtype and local shape, and its bytes. ``rows`` sums them by
    all of that but the bytes."""

    def __init__(self):
        self.tags: list = []
        self.mesh = None
        self._moving = 0

    def __enter__(self):
        from torch.distributed.tensor import _collective_utils as CU
        from torch.distributed.tensor import placement_types as PT
        real_op, real_step, sites = DR.Recorder._op, DR.run_step, self
        real_a2a = CU.shard_dim_alltoall

        def op(rec, func, args, out):
            n = len(rec.calls)
            real_op(rec, func, args, out)
            if len(rec.calls) > n:
                key, nbytes = rec.calls[-1]
                t = DR._local(out if isinstance(out, torch.Tensor)
                              else args[0][0] if isinstance(
                                  args[0], (list, tuple)) else args[0])
                sites.tags.append((
                    "all-to-all" if sites._moving else
                    DR.KINDS[key.split(".", 1)[1]], tuple(_group(args)),
                    _site(), torch._C._current_graph_task_id() != -1,
                    bool(sites._moving),
                    str(t.dtype).replace("torch.", ""), tuple(t.shape),
                    nbytes))

        def a2a(*args, **kw):
            sites._moving += 1
            try:
                return real_a2a(*args, **kw)
            finally:
                sites._moving -= 1

        def step(c):
            sites.mesh = c.mesh
            return real_step(c)
        self._real = real_op, real_step, real_a2a, PT.__dict__.get(
            "shard_dim_alltoall")
        DR.Recorder._op, DR.run_step = op, step
        CU.shard_dim_alltoall = a2a
        if self._real[3] is not None:
            PT.shard_dim_alltoall = a2a
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor import _collective_utils as CU
        from torch.distributed.tensor import placement_types as PT
        DR.Recorder._op, DR.run_step, CU.shard_dim_alltoall, pt = self._real
        if pt is not None:
            PT.shard_dim_alltoall = pt

    def dims(self, ranks) -> str:
        """The mesh dims a group of ``ranks`` spans, major first."""
        mesh = self.mesh
        coords = [(mesh.mesh == r).nonzero()[0].tolist() for r in ranks]
        return "+".join(n for i, n in enumerate(mesh.mesh_dim_names)
                        if len({c[i] for c in coords}) > 1)

    def rows(self) -> list:
        """[{kind, dims, group, site, bwd, shard_move, dtype, shape, calls,
        bytes}], largest bytes first."""
        agg = collections.defaultdict(lambda: [0, 0])
        dims = {}
        for kind, ranks, site, bwd, moving, dtype, shape, n in self.tags:
            if ranks not in dims:
                dims[ranks] = self.dims(ranks)
            e = agg[(kind, dims[ranks], len(ranks), site, bwd, moving,
                     dtype, shape)]
            e[0] += 1
            e[1] += n
        keys = ("kind", "dims", "group", "site", "bwd", "shard_move",
                "dtype", "shape")
        return sorted(({**dict(zip(keys, k)), "shape": list(k[7]),
                        "calls": c, "bytes": b}
                       for k, (c, b) in agg.items()),
                      key=lambda r: (-r["bytes"], r["kind"], r["site"]))


class Peak:
    """Attributes the live bytes the dry-run's ``Recorder`` counts to the
    line of the port that made each storage, while installed (``with
    Peak() as p:``), as ``Sites`` tags collectives: each new storage's
    ``_frame()`` (file, line and function; "-" for the autograd engine's
    own ops), its bytes counted there until it is freed. ``rows`` lists,
    by line, the bytes live at the recorder's peak and the most live at
    once (the last step run): in a cell of few periods the peak can fall
    in the first period's backward, after the later periods' saved inputs
    are freed, and a line's own most shows what it held then."""

    def __init__(self):
        self.live: dict = {}
        self.most: dict = {}
        self.at_peak: dict = {}
        self.peak = self.run = 0

    def __enter__(self):
        import weakref
        real_op, real_step, peak = DR.Recorder._op, DR.run_step, self

        def op(rec, func, args, out):
            new = {id(st): st for st in (DR._local(t).untyped_storage()
                                         for t in DR._tensors(out))
                   if st not in rec._seen}
            real_op(rec, func, args, out)
            for st in new.values():
                n = rec._seen.get(st)
                if n is None:            # DTensor's sharding propagation
                    continue
                f = _frame()
                site = ("-", 0, "-") if f is None else (
                    os.path.relpath(f.f_code.co_filename, PORT), f.f_lineno,
                    f.f_code.co_name)
                peak._add(peak.run, site, n)
                weakref.finalize(st, peak._add, peak.run, site, -n)
            if rec.peak > peak.peak:
                peak.peak = rec.peak
                peak.at_peak = {k: tuple(v) for k, v in peak.live.items()
                                if v[0]}

        def step(c):
            peak.run += 1
            peak.live, peak.most, peak.at_peak, peak.peak = {}, {}, {}, 0
            return real_step(c)
        self._real = real_op, real_step
        DR.Recorder._op, DR.run_step = op, step
        return self

    def __exit__(self, *exc):
        DR.Recorder._op, DR.run_step = self._real

    def _add(self, run, site, n) -> None:
        if run == self.run:              # not a storage of an earlier step
            e = self.live.setdefault(site, [0, 0])
            e[0] += n
            e[1] += 1 if n > 0 else -1
            self.most[site] = max(self.most.get(site, 0), e[0])

    def rows(self) -> list:
        """[{file, line, function, bytes, storages, most}] of every line
        that made a storage: the bytes and storages live at the peak
        (summing to the recorder's peak) and the most bytes live at once;
        largest at the peak first."""
        return sorted(({"file": f, "line": ln, "function": fn,
                        "bytes": self.at_peak.get((f, ln, fn), (0, 0))[0],
                        "storages": self.at_peak.get((f, ln, fn), (0, 0))[1],
                        "most": most}
                       for (f, ln, fn), most in self.most.items()),
                      key=lambda r: (-r["bytes"], -r["most"], r["file"],
                                     r["line"]))


def cell(arch, shape, cell, *, multi_pod=True, mesh=MESH3, variant="baseline",
         dtype=torch.bfloat16, out_dir=None, watch=()):
    """``run_step``'s reading of a cell, with the record when ``out_dir``;
    ``watch`` (a ``Sites``, a ``Peak``) installed around it."""
    rec, runs = None, []
    real = DR.run_step

    def keep(c):
        r = real(c)
        runs.append(r)
        return r
    DR.run_step = keep
    try:
        with contextlib.ExitStack() as stack:
            for w in watch:
                stack.enter_context(w)
            rec = DR.run_cell(arch, shape, multi_pod, out_dir or "", variant,
                              cfg=reduced(get_config(arch)), cell=cell,
                              device_type="cpu", mesh_shape=mesh, dtype=dtype,
                              write=out_dir is not None)
    finally:
        DR.run_step = real
    return rec, runs[0]


def tagged(res, name, *args, peak=False, **kw):
    """``cell`` with its collectives by call site in ``res["sites"][name]``
    and, with ``peak``, its live bytes at the peak by line in
    ``res["peak"][name]`` -> (record, run)."""
    s, p = Sites(), Peak()
    rec, run = cell(*args, watch=(s, p) if peak else (s,), **kw)
    res.setdefault("sites", {})[name] = s.rows()
    if peak:
        res.setdefault("peak", {})[name] = p.rows()
    return rec, run


def constrain_checks() -> list:
    from torch.distributed.tensor import distribute_tensor, Replicate
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_test_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
        con = SH.make_constrainer(mesh)
        out = []
        for shape, axes in (((4, 8, 16), ("data", None, None)),
                            ((4, 8, 4, 16), ("data", None, "model", None)),
                            ((4, 8, 3, 16), ("data", None, "model", None)),
                            ((4, 8, 32), ("data", None, "model"))):
            x = distribute_tensor(torch.zeros(shape), mesh,
                                  [Replicate(), Replicate()])
            got = con(x, axes)
            want = SH.to_placements(mesh, SH.spec(mesh, shape, axes))
            out.append([[str(p) for p in got.placements],
                        [str(p) for p in want],
                        list(got.to_local().shape), con.mesh is mesh])
        return out
    finally:
        dist.destroy_process_group()


def agree(run) -> bool:
    return {k: v[0] for k, v in run.comms.items()} == run.comm_counts


def main() -> None:
    out_dir, part = sys.argv[1], sys.argv[2]
    res = {"recorder": {}}
    if part == "sites":
        full_width_sites(out_dir, *sys.argv[3:])
        return
    if part == "gloo":
        gloo_cells(res)
    elif part == "scale":
        scale_cells(res)
    elif part == "b1":
        b1_cells(res)
    else:
        jax_cells(res, out_dir)
    print("RESULT " + json.dumps(res, default=float))


def jax_cells(res, out_dir) -> None:
    res["arguments"], res["collectives"] = {}, {}

    def keep(name, rec, run):
        res["arguments"][name] = rec["memory_analysis"][
            "argument_size_in_bytes"]
        res["collectives"][name] = {k: rec[k] for k in ("coll_by_kind",
                                                        "coll_bytes")}
        res["recorder"][name] = agree(run)
    rec, run = tagged(res, "train", "yi-6b", "train_4k", TRAIN,
                      out_dir=out_dir, peak=True)
    keep("train", rec, run)
    res["train_record"] = rec
    # the same cell under JAX's "wgather" variant (the dense weights
    # constrained to their TP-only specs at use): read by call site only
    rec, run = tagged(res, "train_wgather", "yi-6b", "train_4k", TRAIN,
                      variant="wgather")
    res["recorder"]["train_wgather"] = agree(run)
    for name, variant in (("decode", "baseline"),
                          ("decode_seqshard", "kv_seqshard")):
        rec, run = tagged(res, name, "yi-6b", "decode_32k", DECODE,
                          variant=variant)
        keep(name, rec, run)
    cfg = reduced(get_config("qwen3-moe-235b-a22b"))
    rec, run = cell("qwen3-moe-235b-a22b", "prefill_32k", PREFILL,
                    variant="moe_shmap")
    B_l = PREFILL.global_batch // 4            # rows over (pod, data)
    res["shmap"] = {
        "allreduce": [n for name, n in run.calls
                      if name == "c10d.allreduce_"],
        "sublayers": cfg.n_layers, "want": B_l * PREFILL.seq_len *
        cfg.d_model * 2, "regions": rec["local_regions"],
        "status": rec["status"]}
    res["recorder"]["shmap"] = agree(run)
    res["constrain"] = constrain_checks()
    res["uneven_heads"] = {}
    for arch in UNEVEN_HEADS:
        rec, _ = cell(arch, "train_4k", TRAIN, multi_pod=False,
                      mesh=UNEVEN_MESH)
        res["uneven_heads"][arch] = {
            "status": rec["status"], "coll_bytes": rec["coll_bytes"],
            "regions": sorted(k for k, v in DR.REGIONS.items()
                              if v in rec["local_regions"])}


def scale_cells(res) -> None:
    res["scale"], res["arguments"], res["collectives"] = {}, {}, {}
    for mesh_name, multi_pod in (("single", False), ("multi", True)):
        rec, run = (tagged(res, "moe_train", "qwen3-moe-235b-a22b",
                           "train_4k", TRAIN) if multi_pod else
                    cell("qwen3-moe-235b-a22b", "train_4k", TRAIN,
                         multi_pod=False))
        res["scale"][mesh_name] = {
            "temp": rec["memory_analysis"]["temp_size_in_bytes"],
            "wire": rec["coll_bytes"], "coll_by_kind": rec["coll_by_kind"]}
        res["recorder"][f"moe_train_{mesh_name}"] = agree(run)
    res["arguments"]["moe_train"] = rec["memory_analysis"][
        "argument_size_in_bytes"]
    res["collectives"]["moe_train"] = {k: rec[k] for k in ("coll_by_kind",
                                                           "coll_bytes")}
    try:                       # one KV head, split over a model dim of 1
        rec, _ = tagged(res, "one_kv", "yi-6b", "train_4k", TRAIN,
                        multi_pod=False, mesh=ONE_KV_MESH)
        res["one_kv"] = {"status": rec["status"],
                         "coll_bytes": rec["coll_bytes"]}
    except Exception as e:     # noqa: BLE001 - the test reads the failure
        res["one_kv"] = {"status": f"failed: {type(e).__name__}: {e}"}


def b1_cells(res) -> None:
    res["arguments"], res["collectives"] = {}, {}
    for name, arch in B1_CELLS.items():
        rec, run = tagged(res, name, arch, "long_500k", DECODE_B1)
        res["arguments"][name] = rec["memory_analysis"][
            "argument_size_in_bytes"]
        res["collectives"][name] = {k: rec[k] for k in ("coll_by_kind",
                                                        "coll_bytes")}
        res["recorder"][name] = agree(run)


def gloo_cells(res) -> None:
    res["gloo"] = {}
    names = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}
    for name, arch, kind, variant, (B, S) in CELLS:
        rec, run = tagged(res, f"gloo_{name}", arch, names[kind],
                          ShapeCell(kind, S, B, kind), multi_pod=False,
                          mesh=mesh_of(name), variant=variant,
                          dtype=torch.float32)
        res["gloo"][name] = {
            "counts": run.comm_counts, "comms": run.comms,
            "regions": sorted(k for k, v in DR.REGIONS.items()
                              if v in run.local_regions)}
        res["recorder"][name] = agree(run)
    res["prefill"] = res["gloo"]["prefill"]


def full_width_sites(out_dir, arch, shape, mesh_name, variant,
                     device_type="cpu") -> None:
    """One full-width cell on its production mesh, its record written to
    ``out_dir``: prints ``RESULT`` and {"stem", "sites", "peak"} (the
    ``Peak`` rows)."""
    s, p = Sites(), Peak()
    with s, p:
        DR.run_cell(arch, shape, mesh_name == "multi", out_dir, variant,
                    device_type=device_type)
    print("RESULT " + json.dumps({
        "stem": DR._stem(arch, shape, mesh_name, variant),
        "sites": s.rows(), "peak": p.rows()}))


if __name__ == "__main__":
    main()
