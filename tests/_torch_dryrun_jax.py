"""JAX's side of ``tests/test_torch_dryrun.py``, one process:

    python tests/_torch_dryrun_jax.py
    python tests/_torch_dryrun_jax.py b1

On 8 placeholder CPU devices, mesh (pod 2, data 2, model 2), JAX's
dry-run pipeline (``repro.launch.dryrun.build_cell``'s steps, shardings and
specs; that module itself is never imported: it forces 512 devices) on
the reduced Yi-6B: a train cell (8 x 32 tokens) and two decode cells (8
rows against a cache of 64: ``cache_pspecs`` plain and sequence-sharded),
and the reduced Qwen3-MoE's train cell (8 x 32; its 4 experts on "model",
Adafactor), bf16 parameters as JAX's dry-run holds them. It prints one JSON object:
each cell's compiled ``memory_analysis().argument_size_in_bytes`` and
its collective bytes by kind (``hloparse.collective_bytes_scaled`` of the
compiled text, the count JAX's dry-run record holds); the
shapes and dtypes of ``launch/specs.py``'s train, prefill and decode specs
of every registry arch at every shape, leaf by leaf; and the
(shape, logical axes) sequence each reduced family's forward hands its
``constrain`` callback, with ``activation_constraints`` on and off and with
``fsdp_weight_gather``, at one period (and one encoder layer): JAX's
scans trace their body once, the port's loops run it once a period.

With ``b1`` it reads, in a process of its own, only the decode cells of
one row (``B1_ARCHS``: the reduced Jamba, Mamba2 and Mixtral, one token
against a cache of 64, fewer rows than the data ranks) on the same mesh:
each one's argument bytes and collective bytes by kind.
"""

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config, reduced  # noqa: E402
from repro.configs.registry import ALIASES  # noqa: E402
from repro.configs.shapes import SHAPES  # noqa: E402
from repro.distributed import hloparse as HP  # noqa: E402
from repro.distributed import sharding as SH  # noqa: E402
from repro.launch import specs as SP  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models.model import LM  # noqa: E402
from repro.training import lm_step, optim as O  # noqa: E402

#: the families the constraint sequence is read on
FAMILIES = ("yi-6b", "qwen3-moe-235b-a22b", "mamba2-780m",
            "jamba-1.5-large-398b", "whisper-tiny", "internvl2-26b",
            "qwen2.5-32b")
#: config changes the sequence is read under
KNOBS = {"on": {}, "off": {"activation_constraints": False},
         "wgather": {"fsdp_weight_gather": True}}
B, S, S_DEC = 8, 32, 64
#: the decode cells of one row, by name
B1_ARCHS = {"decode_b1_hybrid": "jamba-1.5-large-398b",
            "decode_b1_ssm": "mamba2-780m",
            "decode_b1_moe": "mixtral-8x7b"}


def train(mesh, arch):
    """The reduced ``arch``'s compiled train step on ``mesh`` (8 x 32)."""
    cfg = reduced(get_config(arch))
    lm = LM(cfg, constrain=SH.make_constrainer(mesh))
    pspec = lm.param_specs()
    p_sh = SH.to_shardings(mesh, SH.param_pspecs(mesh, pspec))
    optimizer = O.get(cfg.optimizer, 3e-4)
    opt_spec = jax.eval_shape(optimizer.init, pspec)
    o_sh = SH.to_shardings(mesh, SH.param_pspecs(mesh, opt_spec))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    b_sh = SH.to_shardings(mesh, SH.batch_pspec(mesh, batch))
    fn = jax.jit(lm_step.make_train_step(lm, optimizer),
                 in_shardings=(p_sh, o_sh, b_sh), donate_argnums=(0, 1))
    with mesh:
        return lm, p_sh, fn.lower(pspec, opt_spec, batch).compile()


def arguments() -> dict:
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    out, colls = {}, {}
    for name, arch in (("moe_train", "qwen3-moe-235b-a22b"),
                       ("train", "yi-6b")):
        lm, p_sh, compiled = train(mesh, arch)
        out[name] = int(compiled.memory_analysis().argument_size_in_bytes)
        colls[name] = collectives(compiled)
    for name, seq_shard in (("decode", False), ("decode_seqshard", True)):
        compiled = decode(mesh, lm, p_sh, B, seq_shard)
        out[name] = int(compiled.memory_analysis().argument_size_in_bytes)
        colls[name] = collectives(compiled)
    return out, colls


def decode(mesh, lm, p_sh, rows, seq_shard=False):
    """``lm``'s compiled serve step on ``mesh``: ``rows`` tokens against a
    cache of S_DEC."""
    cache = lm.init_cache(rows, S_DEC, dtype=jnp.bfloat16, abstract=True)
    tokens = jax.ShapeDtypeStruct((rows, 1), jnp.int32)
    c_sh = SH.to_shardings(mesh, SH.cache_pspecs(mesh, cache,
                                                 seq_shard=seq_shard))
    t_sh = SH.to_shardings(mesh, SH.batch_pspec(mesh, tokens))
    fn = jax.jit(lm_step.make_serve_step(lm),
                 in_shardings=(p_sh, c_sh, t_sh), donate_argnums=(1,))
    with mesh:
        return fn.lower(lm.param_specs(), cache, tokens).compile()


def decode_b1() -> tuple:
    """The decode cells of one row (``B1_ARCHS``) on (pod 2, data 2,
    model 2)."""
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    out, colls = {}, {}
    for name, arch in B1_ARCHS.items():
        lm = LM(reduced(get_config(arch)), constrain=SH.make_constrainer(mesh))
        p_sh = SH.to_shardings(mesh, SH.param_pspecs(mesh, lm.param_specs()))
        compiled = decode(mesh, lm, p_sh, 1)
        out[name] = int(compiled.memory_analysis().argument_size_in_bytes)
        colls[name] = collectives(compiled)
    return out, colls


def collectives(compiled) -> dict:
    """The compiled step's per-device collective bytes by kind, each while
    body's times its trip count, as JAX's dry-run record takes them, and
    their wire bytes (an all-reduce twice)."""
    by_kind = HP.collective_bytes_scaled(compiled.as_text())
    return {"coll_by_kind": by_kind, "coll_bytes": HP.wire_bytes(by_kind)}


def flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (k,)))
        return out
    return {"/".join(path): [list(tree.shape), str(tree.dtype)]}


def specs() -> dict:
    out = {}
    for arch in ALIASES:
        cfg = get_config(arch)
        lm = LM(cfg)
        for shape in SHAPES:
            out[f"{arch}/{shape}"] = {
                "train": flat(SP.train_batch_specs(cfg, shape)),
                "prefill": flat(SP.prefill_specs(cfg, shape)),
                "decode": flat(SP.decode_specs(cfg, shape, lm))}
    return out


def constraints() -> dict:
    out = {}
    for arch in FAMILIES:
        for knob, change in KNOBS.items():
            cfg = reduced(get_config(arch))
            cfg = dataclasses.replace(
                cfg, n_layers=len(cfg.period),
                enc_layers=min(cfg.enc_layers, 1), **change)
            calls = []

            def record(x, axes):
                calls.append([list(x.shape), json.loads(json.dumps(axes))])
                return x
            lm = LM(cfg, constrain=record)
            params = lm.init_params(jax.random.PRNGKey(0), jnp.float32)
            kw = {}
            if cfg.enc_layers:
                kw["enc_frames"] = jnp.zeros((2, cfg.cross_len, cfg.d_model))
            if cfg.family == "vlm":
                kw["patch_embeds"] = jnp.zeros((2, cfg.n_patches,
                                                cfg.d_model))
            toks = jnp.zeros((2, cfg.dec_max_len if cfg.enc_layers else S),
                             jnp.int32)
            jax.eval_shape(lambda p: lm.forward(p, toks, **kw), params)
            out[f"{arch}/{knob}"] = calls
    return out


if __name__ == "__main__":
    if sys.argv[1:] == ["b1"]:
        args, colls = decode_b1()
        print(json.dumps({"arguments": args, "collectives": colls}))
        raise SystemExit(0)
    args, colls = arguments()
    print(json.dumps({"arguments": args, "collectives": colls,
                      "specs": specs(), "constraints": constraints()}))
