"""The port's production meshes on the fake process group, one process.

    python tests/_torch_fake_mesh.py

For the single-pod (world 256) and the multi-pod (world 512) mesh, built by
``make_production_mesh(device_type="cpu")`` over
``torch.testing._internal.distributed.fake_pg``'s group (rank 0, no
collective moves data), it prints one JSON object: each mesh's dim names
and sizes; for every registry arch, each parameter leaf of a meta ``LM``
with its global shape, its spec and the local shape DTensor gives it under
``to_placements`` of that spec; and a small DTensor laid out by
``distribute_tensor``.
"""

import json

import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs.registry import ALIASES, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.convert import leaf_groups
from repro_torch.models.model import LM


def one(world: int, multi_pod: bool) -> dict:
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rec = SH.mesh_of(mesh)
        out = {"names": list(mesh.mesh_dim_names),
               "sizes": list(mesh.mesh.shape),
               "record": [list(rec.axis_names), list(rec.sizes)],
               "params": {}}
        for arch in ALIASES:
            tree = {g.path: g.leaf for g in
                    leaf_groups(LM(get_config(arch), device="meta"))}
            specs = SH.param_pspecs(mesh, tree)
            rows = {}
            for path, leaf in tree.items():
                shape = tuple(leaf.shape)
                local, _ = compute_local_shape_and_global_offset(
                    shape, mesh, SH.to_placements(mesh, specs[path]))
                rows[path] = [list(shape), [list(e) if isinstance(e, tuple)
                                            else e for e in specs[path]],
                              list(local)]
            out["params"][arch] = rows
        # a real DTensor: batch rows on the data axes, columns on "model"
        s = SH.spec(mesh, (64, 32), ("data", "model"))
        t = distribute_tensor(torch.zeros(64, 32), mesh,
                              SH.to_placements(mesh, s))
        out["dtensor"] = [list(t.to_local().shape),
                          [str(p) for p in t.placements]]
        return out
    finally:
        dist.destroy_process_group()


def main() -> None:
    print(json.dumps({"single": one(256, False), "multi": one(512, True)}))


if __name__ == "__main__":
    main()
