"""One rank of the port's expert-parallel MoE checks, on the CPU over gloo.

    python tests/_torch_shard_map_worker.py DIR RANK WORLD SHAPE AXES

``SHAPE`` is the mesh's sizes and ``AXES`` its dim names, comma-separated
(``2,2 data,model``). The rank joins a gloo group of ``WORLD`` ranks through
a file under ``DIR``, builds the mesh with ``make_test_mesh(...,
device_type="cpu")`` and, for each case of ``DIR/inputs.npz``, runs
``moe_ffn_shard_map`` on its data shard's rows with every expert it does
not own set to NaN, records the routing it used, and takes the gradients
of ``sum(y**2)`` and of aux. It then runs the reduced MoE models through
``LM`` with the mesh's constrainer, beside the same ``LM`` with none. On a
mesh of one rank it also runs ``moe_ffn`` on the same inputs, for the
bitwise checks. Everything goes to ``DIR/rank{RANK}.npz``.
"""

import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config, reduced
from repro_torch.distributed.sharding import make_constrainer
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe
from repro_torch.models.model import LM

NAMES = ("router", "w_gate", "w_up", "w_down")
#: the LM variants each rank runs: the reduced config at capacity factor
#: 1.0 with ``moe_buf_mode="shard_map"``, and a copy with 6 experts (which
#: a model dim of 4 does not divide)
LM_EXPERTS = (None, 6)
LM_TOKENS = (4, 16)


def data_coord(mesh) -> tuple[int, int]:
    """(this rank's data shard, the number of data shards), pod major."""
    j, n = 0, 1
    for a in ("pod", "data"):
        if a in mesh.mesh_dim_names:
            size = mesh.size(mesh.mesh_dim_names.index(a))
            j, n = j * size + mesh.get_local_rank(a), n * size
    return j, n


def sublayer(case, z, mesh, out: dict) -> None:
    meta = json.loads(str(z[f"{case}_meta"]))
    E, k, cf = meta["E"], meta["k"], meta["capacity_factor"]
    msize = mesh.size(mesh.mesh_dim_names.index("model"))
    m, E_loc = mesh.get_local_rank("model"), E // msize
    j, n = data_coord(mesh)
    x = z[f"{case}_x"]
    B_l = x.shape[0] // n
    xl = torch.tensor(x[j * B_l:(j + 1) * B_l], requires_grad=True)
    p = {}
    for name in NAMES:
        w = torch.tensor(z[f"{case}_{name}"])
        if name != "router":          # the experts this rank does not own
            w[:m * E_loc] = float("nan")
            w[(m + 1) * E_loc:] = float("nan")
        p[name] = w.requires_grad_(True)
    seen, real_route = [], moe.route

    def recorded(*args, **kw):
        r = real_route(*args, **kw)
        seen.append(r)
        return r

    moe.route = recorded
    try:
        y, aux = moe.moe_ffn_shard_map(xl, p, n_experts=E, top_k=k,
                                       capacity_factor=cf, mesh=mesh)
    finally:
        moe.route = real_route
    inputs = [xl] + [p[name] for name in NAMES]
    gy = torch.autograd.grad((y ** 2).sum(), inputs, retain_graph=True)
    ga = torch.autograd.grad(aux, inputs, allow_unused=True)
    out[f"{case}_y"] = y.detach().numpy()
    out[f"{case}_aux"] = aux.detach().numpy()
    out[f"{case}_top_i"] = seen[0].top_i.numpy()
    out[f"{case}_keep"] = seen[0].keep.numpy()
    out[f"{case}_rows"] = np.array([j * B_l, (j + 1) * B_l])
    out[f"{case}_experts"] = np.array([m * E_loc, (m + 1) * E_loc])
    for tag, grads in (("gy", gy), ("ga", ga)):
        for name, g in zip(("x",) + NAMES, grads):
            if g is None:
                g = torch.zeros_like(inputs[(("x",) + NAMES).index(name)])
            if name.startswith("w_"):
                g = g[m * E_loc:(m + 1) * E_loc]
            out[f"{case}_{tag}_{name}"] = g.numpy()
    if mesh.size() == 1:
        # moe_ffn on the same inputs, in float32 and bf16
        for dt in (torch.float32, torch.bfloat16):
            xs = torch.tensor(x).to(dt)
            ps = {name: torch.tensor(z[f"{case}_{name}"]).to(
                torch.float32 if name == "router" else dt)
                for name in NAMES}
            got = moe.moe_ffn_shard_map(xs, ps, n_experts=E, top_k=k,
                                        capacity_factor=cf, mesh=mesh)
            want = moe.moe_ffn(xs, ps, n_experts=E, top_k=k,
                               capacity_factor=cf)
            tag = str(dt).split(".")[-1]
            for what, a, b in (("y", got[0], want[0]),
                               ("aux", got[1], want[1])):
                out[f"{case}_{tag}_{what}_bits"] = np.array(
                    [torch.equal(a, b), a.dtype == b.dtype])


def models(arch, mesh, out: dict) -> None:
    """The reduced model through LM with the mesh's constrainer and with
    none: logits, aux and the calls each MoE form took."""
    j, n = data_coord(mesh)
    B, S = LM_TOKENS
    rows = B // n
    for E in LM_EXPERTS:
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  capacity_factor=1.0,
                                  moe_buf_mode="shard_map")
        if E is not None:
            cfg = dataclasses.replace(cfg, n_experts=E)
        tag = f"{arch}_lm_E{cfg.n_experts}"
        toks = torch.from_numpy(np.random.RandomState(3).randint(
            0, cfg.vocab, (B, S)))[j * rows:(j + 1) * rows]
        for dt in (torch.float32, torch.bfloat16):
            lm = LM(cfg, dtype=dt, device="cpu").init_params(
                torch.Generator().manual_seed(0))
            calls = {"moe_ffn_shard_map": 0, "moe_ffn": 0}
            real = {name: getattr(moe, name) for name in calls}

            def counted(name):
                def call(*args, **kw):
                    calls[name] += 1
                    if name == "moe_ffn":
                        calls["buf_mode"] = kw.get("buf_mode")
                    return real[name](*args, **kw)
                return call

            for name in real:
                setattr(moe, name, counted(name))
            try:
                lm.constrain = make_constrainer(mesh)
                logits, aux = lm.forward(toks)
                with_mesh = dict(calls)
                calls.update({"moe_ffn_shard_map": 0, "moe_ffn": 0})
                lm.constrain = None
                plain, plain_aux = lm.forward(toks)
            finally:
                for name, fn in real.items():
                    setattr(moe, name, fn)
            d = str(dt).split(".")[-1]
            out[f"{tag}_{d}_bits"] = np.array(torch.equal(logits, plain))
            out[f"{tag}_{d}_err"] = np.array(float(
                (logits.float() - plain.float()).abs().max()))
            out[f"{tag}_{d}_aux"] = np.array([float(aux), float(plain_aux)])
            out[f"{tag}_{d}_calls"] = np.array(json.dumps(with_mesh))
            out[f"{tag}_{d}_plain_calls"] = np.array(json.dumps(calls))


def main() -> None:
    d, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    shape = tuple(int(s) for s in sys.argv[4].split(","))
    axes = tuple(sys.argv[5].split(","))
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(d, "rendezvous"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_test_mesh(shape, axes, device_type="cpu")
        out = {}
        with np.load(os.path.join(d, "inputs.npz")) as z:
            for case in sorted({n.rsplit("_", 1)[0] for n in z.files
                                if n.endswith("_meta")}):
                sublayer(case, z, mesh, out)
                models(case, mesh, out)
        np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
