"""JAX's side of the expert-parallel MoE checks, on 4 placeholder CPU devices.

    python tests/_torch_shard_map_jax.py DIR

For each case of ``DIR/inputs.npz`` and each mesh of ``MESHES`` (on the
first devices it needs) it runs JAX's ``moe_ffn_shard_map`` under ``jit``
and takes ``jax.grad`` of ``sum(y**2)`` and of aux through it; it also runs
``moe_ffn`` on the whole batch and on each data shard's rows, takes the
gradient of the mean over data shards of each shard's aux, and reads
``moe_ffn``'s routing. Everything goes to ``DIR/jax.npz``.
"""

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.models.moe import moe_ffn, moe_ffn_shard_map  # noqa: E402

MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
NAMES = ("router", "w_gate", "w_up", "w_down")
ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))


def _routing():
    spec = importlib.util.spec_from_file_location(
        "export_torch_fixture",
        os.path.join(ROOT, "scripts", "export_torch_fixture.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script.jax_routing


def main() -> None:
    d = sys.argv[1]
    jax_routing = _routing()
    out = {}
    with np.load(os.path.join(d, "inputs.npz")) as z:
        cases = sorted({n.rsplit("_", 1)[0] for n in z.files
                        if n.endswith("_meta")})
        for case in cases:
            meta = json.loads(str(z[f"{case}_meta"]))
            kw = dict(n_experts=meta["E"], top_k=meta["k"],
                      capacity_factor=meta["capacity_factor"])
            x = jnp.asarray(z[f"{case}_x"])
            p = {name: jnp.asarray(z[f"{case}_{name}"]) for name in NAMES}
            y, aux = moe_ffn(x, p, **kw)
            out[f"{case}_moe_y"] = np.asarray(y)
            out[f"{case}_moe_aux"] = np.asarray(aux)
            top_i, keep = jax_routing(np.asarray(x), np.asarray(p["router"]),
                                      **kw)
            out[f"{case}_top_i"], out[f"{case}_keep"] = top_i, keep
            for name, shape in MESHES.items():
                devs = np.array(jax.devices()[:shape[0] * shape[1]])
                mesh = Mesh(devs.reshape(shape), ("data", "model"))
                fn = jax.jit(lambda x, p, mesh=mesh: moe_ffn_shard_map(
                    x, p, mesh=mesh, **kw))
                tag = f"{case}_{name}"
                with mesh:
                    ys, auxs = fn(x, p)
                    gy = jax.grad(lambda x, p: jnp.sum(fn(x, p)[0] ** 2),
                                  argnums=(0, 1))(x, p)
                    ga = jax.grad(lambda x, p: fn(x, p)[1],
                                  argnums=(0, 1))(x, p)
                out[f"{tag}_y"], out[f"{tag}_aux"] = np.asarray(ys), \
                    np.asarray(auxs)
                for g_tag, (gx, gp) in (("gy", gy), ("ga", ga)):
                    out[f"{tag}_{g_tag}_x"] = np.asarray(gx)
                    for n in NAMES:
                        out[f"{tag}_{g_tag}_{n}"] = np.asarray(gp[n])
                # moe_ffn on each data shard's rows: its aux, and the
                # gradient of the mean over the shards of each one's aux
                D = shape[0]
                rows = x.shape[0] // D

                def mean_aux(x, p):
                    return sum(moe_ffn(x[j * rows:(j + 1) * rows], p, **kw)[1]
                               for j in range(D)) / D

                out[f"{tag}_shard_aux"] = np.array(
                    [float(moe_ffn(x[j * rows:(j + 1) * rows], p, **kw)[1])
                     for j in range(D)])
                gx, gp = jax.grad(mean_aux, argnums=(0, 1))(x, p)
                out[f"{tag}_mean_ga_x"] = np.asarray(gx)
                for n in NAMES:
                    out[f"{tag}_mean_ga_{n}"] = np.asarray(gp[n])
    np.savez(os.path.join(d, "jax.npz"), **out)


if __name__ == "__main__":
    main()
