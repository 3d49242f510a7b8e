"""The port's dry-run (``launch/specs.py``, ``launch/dryrun.py``) and the
sharding constraints it runs on, held to JAX's.

Process groups are global and xdist shares workers, so none is made here:
JAX's side runs on 8 placeholder devices in two ``_torch_dryrun_jax.py``
processes (JAX's ``dryrun.py`` is never imported: it forces 512 devices),
the port's fake cells in four ``_torch_dryrun_fake.py`` processes and the
same sharded steps run for real on four gloo ranks in
``_torch_dryrun_gloo.py``, all started at once under one limit.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import shapes as shp
from repro_torch.configs.registry import ALIASES, get_config, reduced
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SP
from repro_torch.models.model import LM

from _torch_dryrun_fake import MESH3, TRAIN
from _torch_dryrun_gloo import CELLS as GLOO_CELLS, mesh_of

#: the parts of ``_torch_dryrun_fake.py``, each its own process
FAKE_PARTS = ("jax", "gloo", "scale", "b1")
#: the decode cells of one row (fewer rows than the data ranks), read on
#: both sides in processes of their own (``b1``)
B1_CELLS = ("decode_b1_hybrid", "decode_b1_ssm", "decode_b1_moe")
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(ROOT, "src")
JAX_DRYRUN = os.path.join(SRC, "repro", "launch", "dryrun.py")
LIMIT_S = 120
#: JAX's families and knobs of ``_torch_dryrun_jax.py``'s constraint run
FAMILIES = ("yi-6b", "qwen3-moe-235b-a22b", "mamba2-780m",
            "jamba-1.5-large-398b", "whisper-tiny", "internvl2-26b",
            "qwen2.5-32b")
KNOBS = {"on": {}, "off": {"activation_constraints": False},
         "wgather": {"fsdp_weight_gather": True}}
#: the reduced Yi-6B's float32 logits, sharded on four gloo ranks, against
#: its unsharded forward; and every other output of the sharded steps of
#: ``_torch_dryrun_gloo.py`` (logits, aux, loss, gradient norm, parameters,
#: optimiser state, cache) against the unsharded port's
GLOO_TOL = 1e-5


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return env


def _start(*args):
    return subprocess.Popen([sys.executable] + [str(a) for a in args],
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's helper, the fake cells and the four gloo ranks, at once; the
    one-row decode cells (JAX's and the port's) once JAX's helper, the
    first waited on and the longest, has ended, so as not to slow it."""
    tmp = tmp_path_factory.mktemp("dryrun")
    rdv, out = tmp / "gloo", tmp / "records"
    rdv.mkdir()
    out.mkdir()
    fake_py = os.path.join(HERE, "_torch_dryrun_fake.py")
    procs = {"jax": _start(os.path.join(HERE, "_torch_dryrun_jax.py")),
             **{f"fake_{part}": _start(fake_py, out, part)
                for part in FAKE_PARTS if part != "b1"}}
    for r in range(4):
        procs[f"gloo{r}"] = _start(os.path.join(HERE, "_torch_dryrun_gloo.py"),
                                   rdv, r, 4)
    texts = {}
    try:
        names = list(procs)
        for name in names:
            stdout, stderr = procs[name].communicate(timeout=LIMIT_S)
            assert procs[name].returncode == 0, f"{name}: {stderr[-3000:]}"
            texts[name] = stdout
            if name == "jax":
                procs["jax_b1"] = _start(
                    os.path.join(HERE, "_torch_dryrun_jax.py"), "b1")
                procs["fake_b1"] = _start(fake_py, out, "b1")
                names += ["jax_b1", "fake_b1"]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    merged = ("recorder", "gloo", "arguments", "collectives", "sites")
    fake = {key: {} for key in merged}
    for part in FAKE_PARTS:
        got = json.loads(texts[f"fake_{part}"].split("RESULT ", 1)[1])
        for key in merged:
            fake[key].update(got.pop(key, {}))
        fake.update(got)
    gloo = [json.loads((rdv / f"rank{r}.json").read_text())
            for r in range(4)]
    jax = json.loads(texts["jax"])
    for key, cells in json.loads(texts["jax_b1"]).items():
        jax[key].update(cells)
    return {"jax": jax, "fake": fake, "gloo": gloo, "records": out}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): [list(tree.shape),
                             str(tree.dtype).replace("torch.", "")]}


@pytest.mark.parametrize("arch", list(ALIASES))
def test_specs_equal_jax_leaf_for_leaf(runs, arch):
    cfg = get_config(arch)
    lm = LM(cfg, dtype=torch.bfloat16, device="meta")
    for shape in shp.SHAPES:
        want = runs["jax"]["specs"][f"{arch}/{shape}"]
        got = {"train": _flat(SP.train_batch_specs(cfg, shape)),
               "prefill": _flat(SP.prefill_specs(cfg, shape)),
               "decode": _flat(SP.decode_specs(cfg, shape, lm))}
        assert got == want, (arch, shape)


def test_variants_equal_jax():
    tree = ast.parse(open(JAX_DRYRUN).read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "VARIANTS")
    assert DR.VARIANTS == ast.literal_eval(node.value)


def _port_calls(arch, change):
    cfg = reduced(get_config(arch))
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.period),
                              enc_layers=min(cfg.enc_layers, 1), **change)
    calls = []

    def record(x, axes):
        calls.append([list(x.shape), json.loads(json.dumps(axes))])
        return x
    lm = LM(cfg, dtype=torch.float32, device="cpu", constrain=record)
    lm.init_params(torch.Generator().manual_seed(0))
    kw = {}
    if cfg.enc_layers:
        kw["enc_frames"] = torch.zeros(2, cfg.cross_len, cfg.d_model)
    if cfg.family == "vlm":
        kw["patch_embeds"] = torch.zeros(2, cfg.n_patches, cfg.d_model)
    S = cfg.dec_max_len if cfg.enc_layers else 32
    with torch.no_grad():
        lm.forward(torch.zeros(2, S, dtype=torch.int32), **kw)
    return calls


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_constraint_sequence_equals_jax(runs, arch, knob):
    want = runs["jax"]["constraints"][f"{arch}/{knob}"]
    got = _port_calls(arch, KNOBS[knob])
    assert got == want
    if knob == "off":
        assert len(got) == 2             # x after the embedding, the logits


def test_constrainer_keeps_a_plain_tensor_and_its_mesh():
    mesh = SH.Mesh(("data", "model"), (2, 2))
    con = SH.make_constrainer(mesh)
    x = torch.zeros(4, 8, 16)
    assert con(x, ("data", None, None)) is x
    assert con.mesh is mesh


def test_constrainer_redistributes_a_dtensor_to_the_spec(runs):
    for got, want, local, mesh_kept in runs["fake"]["constrain"]:
        assert got == want and mesh_kept
    assert [c[2] for c in runs["fake"]["constrain"]] == [
        [2, 8, 16], [2, 8, 2, 16], [2, 8, 3, 16], [2, 8, 16]]


@pytest.mark.parametrize("cell", ["train", "decode", "decode_seqshard",
                                  "moe_train"] + list(B1_CELLS))
def test_argument_bytes_equal_jax_memory_analysis(runs, cell):
    assert runs["fake"]["arguments"][cell] == runs["jax"]["arguments"][cell]


#: the most the port's collective bytes may be of JAX's HLO count, per
#: cell: (all-reduce bytes, wire bytes); None where the cell holds no bound.
#: Decode keeps every weight in its stored shard and moves the (B, 1, d)
#: activations, where JAX gathers the weights of the 8-row cells (ROADMAP
#: §3, divergences kept on purpose) and moves the rows too in the one-row
#: cells: its wire stays within JAX's
COLLECTIVE_BOUNDS = {"train": (1.5, 1.5), "decode": (None, 1.0),
                     "decode_seqshard": (None, 1.0),
                     "moe_train": (1.5, 1.5),
                     **{c: (None, 1.0) for c in B1_CELLS}}
#: the most the port's all-gather bytes may be of JAX's, in every cell
ALL_GATHER_BOUND = 1.0
#: the cells read by call site on (pod 2, data 2, model 2): the reduced
#: Yi-6B's train step as the baseline lays it out and under "wgather"
#: (the dense weights constrained to their TP-only specs at use), and the
#: reduced Qwen3-MoE's (Adafactor)
TRAIN_SITES = ("train", "train_wgather", "moe_train")
#: the most the reduced Qwen3-MoE's train cell on (pod 2, data 2, model 2)
#: may read of the same cell on (data 2, model 2) at the same global batch:
#: per-rank temp bytes, and wire bytes (an FSDP weight's gather does not
#: shrink with the data dims, in JAX's program either)
POD_SCALING = {"temp": 0.6, "wire": 0.75}


@pytest.mark.parametrize("cell", list(COLLECTIVE_BOUNDS))
def test_collective_bytes_within_jax_hlo_count(runs, cell):
    """The dry-run's collective term against JAX's partitioned program on
    the same cell (``hloparse.collective_bytes_scaled``, the count JAX's
    record holds): all-reduce and wire bytes (an all-reduce twice) a rank
    at most the bound's multiple of JAX's."""
    port = runs["fake"]["collectives"][cell]
    jax = runs["jax"]["collectives"][cell]
    ar_bound, wire_bound = COLLECTIVE_BOUNDS[cell]
    msg = (f"{cell}: port {port['coll_by_kind']} wire {port['coll_bytes']}"
           f"; JAX {jax['coll_by_kind']} wire {jax['coll_bytes']}")
    assert jax["coll_bytes"] > 0 and port["coll_bytes"] > 0, msg
    assert port["coll_bytes"] <= wire_bound * jax["coll_bytes"], msg
    if ar_bound is not None:
        assert port["coll_by_kind"].get("all-reduce", 0) <= \
            ar_bound * jax["coll_by_kind"]["all-reduce"], msg


@pytest.mark.parametrize("cell", list(COLLECTIVE_BOUNDS))
def test_all_gather_bytes_within_jax_hlo_count(runs, cell):
    """The port's all-gather bytes a rank at most JAX's HLO count on the
    same cell: no tensor is gathered where JAX's program would move it
    another way for less (the rope's float32 gather of a head_dim shard,
    the Adafactor factors gathered whole on two layouts)."""
    port = runs["fake"]["collectives"][cell]["coll_by_kind"]
    jax = runs["jax"]["collectives"][cell]["coll_by_kind"]
    assert port.get("all-gather", 0) > 0, (cell, port, jax)
    assert port["all-gather"] <= ALL_GATHER_BOUND * jax["all-gather"], \
        (cell, port, jax)


@pytest.mark.parametrize("cell", TRAIN_SITES)
def test_no_weight_moves_over_one_data_dim(runs, cell):
    """On (pod 2, data 2, model 2) a dense weight is gathered, and its
    gradient reduced, over both data dims in one collective, as JAX's
    partitioner moves it over ("pod", "data"): nothing larger than a
    scalar goes over "pod" or "data" alone (DTensor's redistribution of
    the "wgather" constraint all-reduced each gradient over "data", then
    reduce-scattered it over "pod"; the MoE region summed the load-balance
    means over each data dim in turn)."""
    rows = runs["fake"]["sites"][cell]
    one = [r for r in rows if r["dims"] in ("pod", "data")
           and r["bytes"] > 8 * r["calls"]]
    assert not one, one
    both = {r["kind"] for r in rows if r["dims"] == "pod+data"
            and r["bytes"] > 8 * r["calls"]}
    assert {"all-gather", "reduce-scatter"} <= both, rows


@pytest.mark.parametrize("cell", TRAIN_SITES + ("one_kv",) + tuple(
    f"gloo_{c[0]}" for c in GLOO_CELLS if c[2] == "train"))
def test_train_step_passes_no_shard_between_dims(runs, cell):
    """No collective of the train cells passes a shard from one tensor dim
    to another (DTensor's ``shard_dim_alltoall``: an all-to-all on a card's
    mesh, an all-gather on a CPU one, in steps that differ between torch
    releases); the Adafactor factors move between the gradient's and the
    moments' layouts gathered and cut (``dryrun._redistribute``), the
    Mamba-2 mixer's leaves, splits and SSD inputs are moved by regions
    (``ssm_mixer``), and on a model dim of one rank (``one_kv``) the head's
    weight is gathered at use (``fsdp_gather``)."""
    rows = runs["fake"]["sites"][cell]
    assert rows and not [r for r in rows if r["shard_move"]
                         or r["kind"] == "all-to-all"], rows


@pytest.mark.parametrize("cell", ("decode", "decode_seqshard") + B1_CELLS
                         + tuple(f"gloo_{c[0]}" for c in GLOO_CELLS
                                 if c[2] == "decode"))
def test_decode_step_passes_no_shard_between_dims(runs, cell):
    """No collective of a decode step passes a shard between tensor dims
    (DTensor's plans did at ``_qkv``, ``swiglu`` and the attention's q, in
    steps that moved with torch): each weight stays in its stored shard
    and each move of the token's activations, the cache or the state is
    one explicit collective (the ``decode`` region's policy), so torch
    releases and devices issue the same ones."""
    rows = runs["fake"]["sites"][cell]
    assert rows and not [r for r in rows if r["shard_move"]
                         or r["kind"] == "all-to-all"], rows


@pytest.mark.parametrize("reading", list(POD_SCALING))
def test_pod_axis_shrinks_the_moe_train_step_per_rank(runs, reading):
    """Twice the data-parallel ranks hold half the rows each: the MoE train
    step's per-rank temp and wire bytes fall with the pod axis (the
    Adafactor update of the expert leaves in the gradient's layout, the
    weights gathered and their gradients reduced over both data dims at
    once)."""
    single, multi = (runs["fake"]["scale"][m] for m in ("single", "multi"))
    msg = f"(data 2, model 2) {single}; (pod 2, data 2, model 2) {multi}"
    assert single[reading] > 0, msg
    assert multi[reading] <= POD_SCALING[reading] * single[reading], msg


def test_train_step_saves_its_period_inputs_as_d_shards(runs):
    """The tiny ``train`` cell (the reduced Yi-6B, bf16, on (pod 2, data
    2, model 2)) keeps its residual stream's d over "model" between
    sublayers, where each period's checkpoint saves it (JAX's scan carry):
    the storages made at ``LM._residual`` hold at most (periods + 1)
    shards of (rows, S, d / model) at once, and no more at the
    recorder's peak (the whole stream held twice that)."""
    cfg = reduced(get_config("yi-6b"))
    data, model = 2 * MESH3[0], MESH3[1]        # (pod 2, data 2), model 2
    shard = TRAIN.global_batch // data * TRAIN.seq_len * \
        cfg.d_model // model * torch.bfloat16.itemsize
    made = [r for r in runs["fake"]["peak"]["train"]
            if (r["file"], r["function"]) == ("models/model.py", "_residual")]
    most = sum(r["most"] for r in made)
    assert made and most > 0, runs["fake"]["peak"]["train"]
    assert most <= (cfg.n_periods + 1) * shard, (most, shard, made)
    assert sum(r["bytes"] for r in made) <= (cfg.n_periods + 1) * shard


def test_train_step_with_one_kv_head_at_a_model_dim_of_1(runs):
    """The reduced Yi-6B's one KV head, "split" over a model dim of 1: the
    backward merges a dim of size 1 sharded over a mesh dim of size 1,
    which DTensor refuses to reshape; the ``split_heads`` region
    replicates it there (no collective)."""
    got = runs["fake"]["one_kv"]
    assert got["status"] == "ok" and got["coll_bytes"] > 0, got


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "whisper-tiny"])
def test_train_step_over_heads_the_model_dim_does_not_divide(runs, arch):
    """The gradient of the merged attention output is split back into heads
    a mesh dim does not divide (40 over 16 ranks at full width; 4 over 3
    here): the ``split_heads`` region gathers its columns first."""
    got = runs["fake"]["uneven_heads"][arch]
    assert got["status"] == "ok" and got["coll_bytes"] > 0, got
    assert "split_heads" in got["regions"], got


def test_fake_count_equals_a_real_gloo_run(runs):
    fake = runs["fake"]["prefill"]
    for rank in runs["gloo"]:
        r = rank["prefill"]
        assert r["counts"] == fake["counts"], rank["rank"]
        assert r["comms"] == fake["comms"], rank["rank"]
        assert r["shape"] == [4, 32, 256]
        assert r["logits"] <= GLOO_TOL, r
    assert sum(fake["counts"].values()) > 0


@pytest.mark.parametrize("cell", [c[0] for c in GLOO_CELLS])
def test_fake_count_equals_a_real_gloo_run_in_each_region(runs, cell):
    fake = runs["fake"]["gloo"][cell]
    for r in runs["gloo"]:
        got = r[cell]
        assert got["counts"] == fake["counts"], (cell, r["rank"])
        assert got["comms"] == fake["comms"], (cell, r["rank"])
        assert got["regions"] == fake["regions"], (cell, r["rank"])
    assert sum(fake["counts"].values()) > 0


@pytest.mark.parametrize("cell", [c[0] for c in GLOO_CELLS])
def test_sharded_step_equals_the_unsharded_port(runs, cell):
    kind = {c[0]: c[2] for c in GLOO_CELLS}[cell]
    for r in runs["gloo"]:
        got = r[cell]
        if kind == "train":
            assert got["step"], (cell, r["rank"])
            for key in ("loss", "grad_norm", "params"):
                assert got[key] <= GLOO_TOL, (cell, key, got)
            assert max(got["state"].values()) <= GLOO_TOL, (cell, got)
            # the update moved the parameters, and the state is not zero
            assert got["moved"] > 10 * GLOO_TOL and got["state_max"] > 0
        else:
            assert got["logits"] <= GLOO_TOL, (cell, got)
            assert got.get("cache", 0) <= GLOO_TOL, (cell, got)
        if kind == "prefill" and cell != "moe_shmap":
            # (JAX's shard_map returns data rank 0's aux: ROADMAP §3)
            assert got["aux"] <= GLOO_TOL, (cell, got)


@pytest.mark.parametrize("case", ["gather0", "gather1", "scatter0",
                                  "scatter1", "reduce"])
def test_flat_data_collective_equals_dtensors_redistribution(runs, case):
    """On (pod 2, data 2, model 1), ``_redistribute`` gathers,
    reduce-scatters or all-reduces over both data dims in one collective
    and each rank ends with the shard DTensor's own redistribution gives
    (summed in another order: 1e-5)."""
    kind = {"gather": "all_gather_into_tensor",
            "scatter": "reduce_scatter_tensor",
            "reduce": "all_reduce"}[case.rstrip("01")]
    for r in runs["gloo"]:
        got = r["flat"][case]
        assert got["err"] <= GLOO_TOL and got["placements"], (r["rank"], got)
        assert [(k.split(".")[1], v[0]) for k, v in got["comms"].items()] \
            == [(kind, 1)], (r["rank"], got)


def test_redistribute_over_one_rank_moves_nothing(runs):
    """A mesh dim of one rank holds the whole tensor: ``_redistribute``
    issues no collective over it (a world-1 step reads none)."""
    for r in runs["gloo"]:
        got = r["flat"]["one_rank"]
        assert got["err"] <= GLOO_TOL and got["placements"], (r["rank"], got)
        assert got["comms"] == {}, (r["rank"], got)


def test_gloo_runs_take_every_region_and_copied_leaves(runs):
    taken = {reg for r in runs["gloo"] for c in GLOO_CELLS
             for reg in r[c[0]]["regions"]}
    assert taken == set(DR.REGIONS)
    train = runs["gloo"][0]["train"]    # stack_wgather: every stacked leaf
    lm = LM(reduced(get_config("yi-6b")), device="meta")
    assert sorted(train["copies"]) == sorted(lm.stacked)
    assert runs["gloo"][0]["moe"]["aux_abs"] > 0


def test_recorder_count_equals_comm_debug_mode(runs):
    assert all(runs["fake"]["recorder"].values()), runs["fake"]["recorder"]


def test_moe_shmap_one_all_reduce_of_local_rows_per_sublayer(runs):
    sm = runs["fake"]["shmap"]
    assert sm["status"] == "ok"
    assert sum(n == sm["want"] for n in sm["allreduce"]) == sm["sublayers"]
    assert all(n in (sm["want"], 4) for n in sm["allreduce"])  # + aux
    assert any("moe_ffn_shard_map" in r for r in sm["regions"])


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_attention_fake_path_allocates_the_kernels_tensors(device):
    B, Hq, Hkv, S, D = 2, 8, 2, 1024, 64
    rec = DR.Recorder()
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        q = torch.empty(B, Hq, S, D, dtype=torch.bfloat16, device=device)
        k = torch.empty(B, Hkv, S, D, dtype=torch.bfloat16, device=device)
        v = torch.empty_like(k)
        before = dict(fa.LAUNCHES)
        with rec.mode:
            out, lse = fa.flash_attention(q, k, v, return_lse=True)
            dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, out)
    assert mode is not None and fa.LAUNCHES == before
    assert (out.shape, out.dtype) == (q.shape, q.dtype)
    assert (lse.shape, lse.dtype) == ((B, Hq, S), torch.float32)
    assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, v.shape]
    # the output, the statistic, dq, dk, dv and the backward's float32
    # scratch, all live at once at the peak; nothing of (Sq x Skv)
    bf16, f32 = 2, 4
    assert rec.peak == (2 * B * Hq * S * D + 2 * B * Hkv * S * D) * bf16 \
        + 2 * B * Hq * S * f32
    assert rec.peak < B * Hq * S * S * f32


def test_run_cell_writes_jax_keys_and_stems(runs):
    rec = runs["fake"]["train_record"]
    jax_keys = {"arch", "shape", "mesh", "variant", "status", "chips",
                "lower_s", "compile_s", "flops_per_chip", "bytes_per_chip",
                "raw_hlo_flops", "raw_hlo_bytes", "coll_bytes",
                "coll_by_kind", "model_flops", "compute_s", "memory_s",
                "collective_s", "bottleneck", "useful_ratio", "step_s",
                "mfu", "memory_analysis"}
    assert jax_keys <= set(rec)
    assert set(rec["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes"}
    assert rec["collectives_from"] == "CommDebugMode"
    assert rec["status"] == "ok" and rec["fits"] is True
    stem = "yi-6b__train_4k__multi.json"
    assert sorted(os.listdir(runs["records"])) == ["comms", stem]
    assert os.listdir(runs["records"] / "comms") == [stem]
    saved = json.loads((runs["records"] / stem).read_text())
    assert saved["memory_analysis"] == rec["memory_analysis"]


@pytest.mark.parametrize("arch", [a for a in ALIASES
                                  if not get_config(a).subquadratic])
def test_long_500k_skipped_with_jax_reason(arch, tmp_path):
    from repro.configs import shapes as jax_shapes
    rec = DR.run_cell(arch, "long_500k", False, str(tmp_path),
                      device_type="cpu")
    ok, why = jax_shapes.applicable(get_config(arch), "long_500k")
    assert not ok
    assert rec == {"arch": arch, "shape": "long_500k", "mesh": "single",
                   "variant": "baseline", "status": "skipped",
                   "reason": why}
    name = f"{arch.replace('.', '_')}__long_500k__single.json"
    assert json.loads((tmp_path / name).read_text()) == rec


@pytest.mark.parametrize("variant", list(DR.VARIANTS))
def test_fields_the_port_lacks_are_in_no_effect(variant):
    change = DR.VARIANTS[variant].get("cfg", {})
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"), **change)
    notes = DR.no_effect(cfg)
    if change.get("attn_gqa_mode") == "repeat":
        assert any(n.startswith("attn_gqa_mode=repeat") for n in notes)
    mode = change.get("moe_buf_mode", "e_sharded")
    assert any(n.startswith(f"moe_buf_mode={mode}") for n in notes) == \
        (mode != "shard_map")
    dense = dataclasses.replace(get_config("yi-6b"), **change)
    assert not any(n.startswith("moe_buf_mode") for n in DR.no_effect(dense))


def test_dryrun_modules_import_neither_jax_nor_repro():
    for name in ("specs.py", "dryrun.py"):
        path = os.path.join(SRC, "repro_torch", "launch", name)
        tree = ast.parse(open(path).read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names] + [
            n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.module and not n.level]
        assert mods and not [m for m in mods if m.split(".")[0] in
                             ("jax", "jaxlib", "repro")], (name, mods)


def test_dryrun_refuses_a_card_that_is_not_there(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DR.run_cell("yi-6b", "train_4k", False, write=False)
    assert not dist.is_initialized()
