"""Write the fixtures the PyTorch port is checked against, from the JAX package.

The port (``src/repro_torch``) and its ``chip_smoke.py`` may not import JAX,
so the JAX side's artifact and outputs are exported once, here, into
``src/repro_torch/assets/``:

  * ``mnist_ttfs.npz`` — the paper-geometry deployment artifact (784 -> 150,
    10 groups x 15, T = 32), trained and exported exactly the way
    ``benchmarks/common.py::get_artifact_and_data`` does it;
  * ``mnist_ttfs_expected.npz`` — the JAX package's outputs on the 10,000
    procedural test images (``mnist.load("test")``): reference labels,
    served latency-mode labels and steps, SHA-256 digests of the
    reference's ``first_spike`` / ``v_final`` and of the image array, and
    the artifact and program fingerprints;
  * ``fuzz_seed{0..7}.npz`` — the adversarial artifacts and images of
    ``repro.conformance.fuzz.fuzz_case(seed)`` (their reference outputs are
    ``tests/golden/conformance_seed*.npz``). Each holds the saved artifact
    file as raw bytes (``artifact``; ``Artifact.load(io.BytesIO(...))``
    reads it back) beside ``images`` and ``times``;
  * ``mnist_board_expected.npz`` — the JAX board emulator
    (``board-batched-jnp``) on the committed ``mnist_ttfs.npz`` over the
    10,000 test images, in full-T and latency mode, each with the
    artifact's E_max and again with ``events.e_max`` forced to 8 (the FIFO
    stalls). For each of these four runs, keyed ``{full,latency}[_emax8]``:
    SHA-256 digests of the per-image trace ``cycles``, ``events``,
    ``stalls``, ``ticks`` (int64) and ``energy_nj`` (float64), their totals
    (``…_total``; ``energy_nj_total`` is ``np.sum`` of the float64 array),
    and digests of the labels, steps, ``first_spike`` and ``v_final``
    (int32). Beside them, the JAX reference's dense baselines
    (``SNNReference.dense_labels``): ``dense_{fp32,int8}_labels_sha256`` and
    ``dense_{fp32,int8}_accuracy``. ``--only-board`` writes this file alone,
    from the committed artifact, without retraining or rewriting any other
    asset;
  * ``transport_expected.npz`` — the JAX package's program envelopes
    (``repro.core.program_io.serialize_program`` of ``lower(art,
    cache=False)``, uint8 bytes) of the committed ``mnist_ttfs.npz``
    (``envelope_mnist``) and of the eight pinned fuzz artifacts
    (``envelope_fuzz_seed{s}``), and the JAX reference's labels for the
    launcher's SNN request stream (``repro.launch.serve.serve_snn``:
    ``RandomState(0).rand(10000, n_in)`` in float32; ``serve_labels``,
    ``serve_images_sha256``). ``--only-transport`` writes this file alone,
    from the committed artifacts;
  * ``faults_expected.npz`` — the JAX fault subsystem (``repro.faults``)
    on the committed artifacts (``static_plans`` and ``dynamic_plans``
    name the plans, in order): ``plans_json``, the parse, ``describe``,
    lane split, scrub and first ``rng`` draws of each spec in
    ``PLAN_SPECS``; for each case (MNIST and the eight fuzz seeds) and each
    static plan of ``STATIC_PLANS``, the bits ``corrupt_artifact`` flipped
    (``corrupt_{case}_{i}_{array}_idx``/``_val``: flat indices and new
    values), the clone's fingerprint and its checksum messages; for each
    dynamic plan of ``DYNAMIC_PLANS`` (full-T and latency mode), ``board-py``
    on the first ``BOARD_PY_IMAGES`` test images and on each fuzz case's
    images: labels, steps, ``last_ecc``, the trace fields and the stuck
    groups as arrays, digests of ``first_spike``, ``v_final`` and
    ``last_tick_counts`` (``board_{case}_{i}_{mode}_…``), or, where JAX's
    membrane upset raises ``OverflowError`` (it flips bit 31 of a negative
    membrane and wraps one way only), its message (``…_jax_raises``) and
    nothing else; and the canary
    built from each case (MNIST with the first 64 test images as its pool,
    each fuzz case with its own images): ``canary_{case}_images``,
    ``_want``, ``_covered``. ``--only-faults`` writes this file alone, from
    the committed artifacts;
  * ``moe_expected.npz`` — the JAX package's ``moe_ffn`` on the inputs of
    ``MOE_CASES`` (a Mixtral-like and a Qwen3-MoE-like layer at capacity
    factor 1.0, so that assignments drop): for each case, ``{case}_meta``
    (the JSON recipe ``draw_moe_case`` draws x and the weights from, with
    its ``numpy.random.RandomState`` seed; the inputs are not stored),
    ``{case}_out`` (float32), ``{case}_aux``, ``{case}_top_i`` and
    ``{case}_keep`` (the routing ``jax_routing`` reads off JAX's own
    functions). ``--only-moe`` writes this file alone;
  * ``whisper_expected.npz`` — the JAX package's float32 whisper-tiny at
    full width, on the CPU, with every weight, the frames and the tokens
    drawn by ``draw_whisper_case`` from the JSON recipe ``WHISPER_CASE``
    (``meta``; its ``numpy.random.RandomState`` seed, nothing of JAX's
    initialiser): ``enc_out`` (the encoder's output at the frames
    ``meta["enc_rows"]``) and ``logits`` (``forward(tokens,
    enc_frames=frames)`` at the positions ``meta["logit_positions"]``), both
    float32. ``chip_smoke.py`` redraws the same model and inputs without
    JAX. ``--only-whisper`` writes this file alone;
  * ``lm_train_expected.npz`` — the JAX package's jitted train step
    (``repro.training.lm_step.make_train_step``) on the reduced Yi-6B, its
    float32 parameters drawn by ``draw_lm_train_case`` from the JSON recipe
    ``LM_TRAIN_CASE`` (``meta``: the ``RandomState`` seed, the batch and
    the runs), for ``meta["steps"]`` steps of ``TokenPipeline`` batches in
    each run (AdamW; Adafactor; SGD with two micro-batches and int8
    compression): ``{run}_loss`` and ``{run}_grad_norm`` (float32, a value a
    step) and ``{run}/{path}``, each parameter leaf after the last step
    (float32, JAX's stacked layout). ``chip_smoke.py`` redraws the model
    without JAX and trains it on the card. ``--only-lm-train`` writes this
    file alone.

Run from the repo root (the CPU is enough):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py \
        --only-board
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py \
        --only-transport
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py \
        --only-faults
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py \
        --only-moe
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py \
        --only-whisper
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py \
        --only-lm-train
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import hashlib
import io
import json
import os
import tempfile
import time

import numpy as np

from repro.board import SNNBoardBatched
from repro.conformance.fuzz import fuzz_case
from repro.conformance.golden import PINNED_SEEDS
from repro.core import deploy
from repro.core.artifact import Artifact
from repro.core.lowering import lower
from repro.core.program_io import serialize_program
from repro.core.reference import SNNReference
from repro.data import mnist
from repro.faults import Canary, FaultPlan, corrupt_artifact, integrity_errors
from repro.configs.registry import get_config
from repro.models import moe as jmoe
from repro.serving.snn_engine import SNNServeEngine
from repro.training.ttfs_trainer import train_dense_proxy

ASSETS = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                      "assets")


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def export_mnist(out_dir: str) -> None:
    t0 = time.perf_counter()
    # mnist.load("train"/"test") are generate(60000, 1234) / generate(10000,
    # 1235); generating directly keeps the script off the on-disk cache
    xtr, ytr = mnist.generate(60_000, 1234)
    xte, yte = mnist.generate(10_000, 1235)
    res = train_dense_proxy(xtr, ytr, test_images=xte, test_labels=yte,
                            epochs=3)
    path = os.path.join(out_dir, "mnist_ttfs.npz")
    deploy.export(res.model, path, calib_images=xtr[:8192],
                  calib_labels=ytr[:8192])
    art = Artifact.load(path)
    print(f"trained + exported {path} in {time.perf_counter() - t0:.1f}s")

    ref = SNNReference(art)
    labels, first, v = [], [], []
    for i in range(0, len(xte), 1000):
        out = ref.forward(xte[i:i + 1000])
        labels.append(np.asarray(out.labels, np.int32))
        first.append(np.asarray(out.first_spike, np.int32))
        v.append(np.asarray(out.v_final, np.int32))
    labels = np.concatenate(labels)
    first = np.concatenate(first)
    v = np.concatenate(v)

    served = {}
    for latency in (False, True):
        eng = SNNServeEngine(art, max_batch=64, latency_mode=latency)
        for img in xte:
            eng.submit(img)
        done = eng.flush()
        reqs = [done[r] for r in sorted(done)]
        served[latency] = (np.asarray([r.label for r in reqs], np.int32),
                           np.asarray([r.steps for r in reqs], np.int32),
                           eng.stats()["overflow_fallbacks"])
        eng.close()
    assert np.array_equal(served[False][0], labels), "served != reference"
    assert np.array_equal(served[True][0], labels), "latency != reference"

    np.savez(os.path.join(out_dir, "mnist_ttfs_expected.npz"),
             labels=labels,
             labels_latency=served[True][0],
             steps_latency=served[True][1],
             overflow_rows=np.int32(served[False][2]),
             first_spike_sha256=np.array(digest(first)),
             v_final_sha256=np.array(digest(v)),
             images_sha256=np.array(digest(xte)),
             artifact_fingerprint=np.array(art.fingerprint()),
             program_fingerprint=np.array(lower(art, cache=False).fingerprint),
             accuracy=np.float64(np.mean(labels == yte)))
    print(f"reference accuracy {np.mean(labels == yte):.4f}, "
          f"overflow rows {served[False][2]}, "
          f"mean latency steps {served[True][1].mean():.2f}")


def export_fuzz(out_dir: str) -> None:
    for seed in PINNED_SEEDS:
        case = fuzz_case(seed)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "artifact.npz")
            case.artifact.save(path)
            with open(path, "rb") as f:
                blob = f.read()
        # the saved file must read back to the same fingerprint
        assert Artifact.load(io.BytesIO(blob)).fingerprint() == \
            case.artifact.fingerprint()
        np.savez_compressed(
            os.path.join(out_dir, f"fuzz_seed{seed}.npz"),
            artifact=np.frombuffer(blob, np.uint8),
            images=case.images, times=case.times)
    print(f"wrote {len(PINNED_SEEDS)} fuzz cases")


#: the board's per-image trace fields kept in mnist_board_expected.npz
BOARD_TRACE = ("cycles", "events", "stalls", "ticks", "energy_nj")
#: the board's outputs kept as digests
BOARD_OUTPUTS = ("labels", "steps", "first_spike", "v_final")


def export_board(out_dir: str, chunk: int = 1000) -> None:
    t0 = time.perf_counter()
    art = Artifact.load(os.path.join(out_dir, "mnist_ttfs.npz"))
    xte, yte = mnist.generate(10_000, 1235)
    meta = copy.deepcopy(art.meta)
    meta["events"]["e_max"] = 8
    arts = {"": art, "_emax8": Artifact(meta, dict(art.arrays))}
    out = {"images_sha256": np.array(digest(xte)),
           "artifact_fingerprint": np.array(art.fingerprint())}
    for suffix, a in arts.items():
        for mode, latency in (("full", False), ("latency", True)):
            board = SNNBoardBatched(a, latency_mode=latency, kernel="jnp")
            outs = {k: [] for k in BOARD_OUTPUTS}
            trace = {k: [] for k in BOARD_TRACE}
            for i in range(0, len(xte), chunk):
                o = board.forward(xte[i:i + chunk])
                for k in BOARD_OUTPUTS:
                    outs[k].append(np.asarray(getattr(o, k), np.int32))
                for k in BOARD_TRACE:
                    trace[k].append(getattr(board.last_trace, k))
            key = mode + suffix
            for k in BOARD_OUTPUTS:
                out[f"{key}_{k}_sha256"] = np.array(
                    digest(np.concatenate(outs[k])))
            for k in BOARD_TRACE:
                a_k = np.concatenate(trace[k])
                assert a_k.dtype == (np.float64 if k == "energy_nj"
                                     else np.int64), (k, a_k.dtype)
                out[f"{key}_{k}_sha256"] = np.array(digest(a_k))
                out[f"{key}_{k}_total"] = np.sum(a_k)
            labels = np.concatenate(outs["labels"])
            out[f"{key}_accuracy"] = np.float64(np.mean(labels == yte))
            print(f"board {key}: accuracy {np.mean(labels == yte):.4f}, "
                  f"cycles/image {out[key + '_cycles_total'] / len(xte):.4f}, "
                  f"nJ/image {out[key + '_energy_nj_total'] / len(xte):.4f}, "
                  f"stalls {out[key + '_stalls_total']}")
    ref = SNNReference(art)
    for mode in ("fp32", "int8"):
        labels = np.concatenate([
            np.asarray(ref.dense_labels(xte[i:i + chunk], mode), np.int32)
            for i in range(0, len(xte), chunk)])
        out[f"dense_{mode}_labels_sha256"] = np.array(digest(labels))
        out[f"dense_{mode}_accuracy"] = np.float64(np.mean(labels == yte))
        print(f"dense {mode}: accuracy {np.mean(labels == yte):.4f}")
    path = os.path.join(out_dir, "mnist_board_expected.npz")
    np.savez(path, **out)
    print(f"wrote {path} in {time.perf_counter() - t0:.1f}s")


#: the launcher's SNN request stream that ``transport_expected.npz`` labels
SERVE_REQUESTS = 10_000


def serve_images(n_in: int, requests: int = SERVE_REQUESTS) -> np.ndarray:
    """``repro.launch.serve.serve_snn``'s requests."""
    return np.random.RandomState(0).rand(requests, n_in).astype(np.float32)


def transport_expected(out_dir: str, chunk: int = 1000) -> dict:
    """The arrays of ``transport_expected.npz``, from the artifacts in
    ``out_dir``."""
    art = Artifact.load(os.path.join(out_dir, "mnist_ttfs.npz"))
    prog = lower(art, cache=False)
    out = {"envelope_mnist": np.frombuffer(serialize_program(prog), np.uint8)}
    for seed in PINNED_SEEDS:
        with np.load(os.path.join(out_dir, f"fuzz_seed{seed}.npz")) as z:
            fart = Artifact.load(io.BytesIO(z["artifact"].tobytes()))
        out[f"envelope_fuzz_seed{seed}"] = np.frombuffer(
            serialize_program(lower(fart, cache=False)), np.uint8)
    images = serve_images(prog.n_in)
    ref = SNNReference(art)
    out["serve_labels"] = np.concatenate([
        np.asarray(ref.forward(images[i:i + chunk]).labels, np.int32)
        for i in range(0, len(images), chunk)])
    out["serve_images_sha256"] = np.array(digest(images))
    return out


def export_transport(out_dir: str) -> None:
    t0 = time.perf_counter()
    out = transport_expected(out_dir)
    path = os.path.join(out_dir, "transport_expected.npz")
    np.savez(path, **out)
    print(f"wrote {path} in {time.perf_counter() - t0:.1f}s: MNIST envelope "
          f"{out['envelope_mnist'].size} bytes, "
          f"{len(out['serve_labels'])} served labels")


#: fault-plan specs whose parse, describe, lane split, scrub and rng draws
#: ``faults_expected.npz`` keeps
PLAN_SPECS = ("", "seu_weight=4,aer_drop=0.02,crash=0:2,seed=7", "fifo=4",
              "persistent=true,stuck=1", "seu_thr=1", "crash=0,seed=3",
              "membrane=0.9,seed=15", "stuck=1,seed=13",
              "aer_dup=0.3,aer_reorder=0.2,seed=4",
              "hang=0,slow=0.01,lanes=0:1,seed=2",
              "seu_weight_flips=4,persistent=1,seed=9",
              "stuck=2,stuck_mode=silent,hang_s=1.5,seed=11")
#: the seeded streams whose first draws are kept, per plan
RNG_STREAMS = (("seu-w",), ("seu-thr",), ("aer", 0), ("aer", 1),
               ("membrane", 0), ("membrane", 3), ("stuck",))
#: static (artifact SEU) plans applied to every case
STATIC_PLANS = ("seu_weight=3,seu_thr=1,seed=9", "seu_weight=4,seed=5",
                "seu_weight=4,persistent=1,seed=9", "seu_thr=2,seed=1",
                "seu_weight=64,seu_thr=8,seed=23")
#: dynamic (board datapath) plans run through board-py. JAX's membrane
#: upset raises OverflowError when it flips bit 31 of a negative membrane
#: (it wraps one way only); the membrane plans' rates are low enough that
#: JAX completes most of these runs
DYNAMIC_PLANS = ("fifo=1", "membrane=0.05,seed=3", "membrane=0.2,seed=25",
                 "stuck=1,seed=5", "stuck=2,stuck_mode=silent,seed=3",
                 "aer_drop=0.3,seed=4", "aer_dup=0.5,seed=1",
                 "aer_reorder=0.5,seed=1",
                 "aer_drop=0.1,aer_dup=0.1,aer_reorder=0.1,stuck=1,fifo=4,"
                 "seed=21")
#: MNIST test images board-py runs under each dynamic plan
BOARD_PY_IMAGES = 64


def plan_record(spec: str) -> dict:
    """What ``plans_json`` keeps of one spec."""
    plan = FaultPlan.parse(spec)
    fields = {f.name: getattr(plan, f.name)
              for f in dataclasses.fields(plan)}
    return {"spec": spec, "fields": json.loads(json.dumps(fields)),
            "describe": plan.describe(),
            "lane1": plan.for_lane(1).describe(),
            "scrub": plan.after_scrub().describe(),
            "flags": [plan.has_static, plan.has_dynamic,
                      plan.has_lane_faults, plan.has_aer_faults,
                      plan.is_clean],
            "rng": [plan.rng(*stream).randint(1 << 30, size=8).tolist()
                    for stream in RNG_STREAMS]}


def fault_cases(out_dir: str) -> dict:
    """case name -> (artifact, board-py images, canary pool), the cases of
    ``faults_expected.npz``."""
    art = Artifact.load(os.path.join(out_dir, "mnist_ttfs.npz"))
    xte, _ = mnist.generate(10_000, 1235)
    cases = {"mnist": (art, xte[:BOARD_PY_IMAGES], xte[:64])}
    for seed in PINNED_SEEDS:
        with np.load(os.path.join(out_dir, f"fuzz_seed{seed}.npz")) as z:
            fart = Artifact.load(io.BytesIO(z["artifact"].tobytes()))
            images = z["images"]
        cases[f"fuzz{seed}"] = (fart, images, images)
    return cases


def faults_expected(out_dir: str) -> dict:
    """The arrays of ``faults_expected.npz``, from the artifacts in
    ``out_dir``."""
    from repro.core.runtimes import make_runtime
    out = {"plans_json": np.array(json.dumps(
        [plan_record(s) for s in PLAN_SPECS], sort_keys=True)),
           "static_plans": np.array(STATIC_PLANS),
           "dynamic_plans": np.array(DYNAMIC_PLANS)}
    for case, (art, images, pool) in fault_cases(out_dir).items():
        for i, spec in enumerate(STATIC_PLANS):
            bad = corrupt_artifact(art, FaultPlan.parse(spec))
            key = f"corrupt_{case}_{i}"
            for name, a in art.arrays.items():
                flat, got = a.reshape(-1), bad.arrays[name].reshape(-1)
                idx = np.nonzero(flat != got)[0]
                if idx.size:
                    out[f"{key}_{name}_idx"] = idx.astype(np.int64)
                    out[f"{key}_{name}_val"] = got[idx]
            out[f"{key}_fingerprint"] = np.array(bad.fingerprint())
            out[f"{key}_errors"] = np.array(json.dumps(integrity_errors(bad)))
        for i, spec in enumerate(DYNAMIC_PLANS):
            for mode, latency in (("full", False), ("latency", True)):
                rt = make_runtime(art, "board-py", latency_mode=latency,
                                  faults=spec)
                key = f"board_{case}_{i}_{mode}"
                try:
                    o = rt.forward(images)
                except OverflowError as e:
                    # JAX's one-way wrap of a membrane upset (ROADMAP §3):
                    # kept as what JAX did, nothing to compare against
                    out[f"{key}_jax_raises"] = np.array(str(e))
                    continue
                out[f"{key}_labels"] = np.asarray(o.labels, np.int32)
                out[f"{key}_steps"] = np.asarray(o.steps, np.int32)
                out[f"{key}_first_spike_sha256"] = np.array(
                    digest(np.asarray(o.first_spike, np.int32)))
                out[f"{key}_v_final_sha256"] = np.array(
                    digest(np.asarray(o.v_final, np.int32)))
                out[f"{key}_tick_counts_sha256"] = np.array(
                    digest(rt.last_tick_counts))
                out[f"{key}_ecc"] = rt.last_ecc
                out[f"{key}_stuck"] = np.asarray(rt.stuck_groups, np.int64)
                for k in BOARD_TRACE:
                    out[f"{key}_{k}"] = np.asarray(getattr(rt.last_trace, k))
        canary = Canary.from_artifact(art, pool=pool)
        out[f"canary_{case}_images"] = canary.images
        out[f"canary_{case}_want"] = canary.want
        out[f"canary_{case}_covered"] = np.asarray(canary.covered_groups,
                                                   np.int64)
    return out


def export_faults(out_dir: str) -> None:
    t0 = time.perf_counter()
    out = faults_expected(out_dir)
    path = os.path.join(out_dir, "faults_expected.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path} in {time.perf_counter() - t0:.1f}s: {len(out)} "
          f"arrays, {os.path.getsize(path)} bytes")


#: the MoE layers of moe_expected.npz: width, experts, top-k, expert width,
#: batch, sequence, capacity factor (1.0: the loads are uneven and
#: assignments drop), the router's scale and the RandomState seed. The
#: scale gives the logits of the full-width models' routers (0.02 at d 4096,
#: std 1.3): at 0.5 (std 8, |logit| up to 30) one float32 step of a logit
#: moves the renormalised weights by 3e-6 and the outputs by 1e-5 between
#: two correct float32 products (the routing itself does not depend on the
#: scale)
MOE_CASES = {
    "mixtral": dict(d=256, E=8, k=2, f=512, B=2, S=128, capacity_factor=1.0,
                    router_scale=0.08, seed=23),
    "qwen3_moe": dict(d=256, E=32, k=8, f=128, B=2, S=128,
                      capacity_factor=1.0, router_scale=0.08, seed=24),
}


def draw_moe_case(meta: dict) -> tuple[np.ndarray, dict]:
    """x (B, S, d) and the MoE weights of a ``MOE_CASES`` recipe, float32,
    drawn from ``RandomState(seed)`` in this order: x, router, w_gate, w_up,
    w_down (``chip_smoke.py`` draws them the same way)."""
    rng = np.random.RandomState(meta["seed"])
    d, E, f = meta["d"], meta["E"], meta["f"]
    x = rng.randn(meta["B"], meta["S"], d).astype(np.float32)
    p = {"router": (rng.randn(d, E) * meta["router_scale"]).astype(np.float32)}
    for name, shape in (("w_gate", (E, d, f)), ("w_up", (E, d, f)),
                        ("w_down", (E, f, d))):
        p[name] = (rng.randn(*shape) / np.sqrt(shape[1])).astype(np.float32)
    return x, p


def jax_routing(x, router, *, n_experts: int, top_k: int,
                capacity_factor: float) -> tuple[np.ndarray, np.ndarray]:
    """(top_i (B, S, k), keep (B, S*k)) as ``repro.models.moe.moe_ffn``
    computes them, line for line in JAX (moe_ffn returns neither)."""
    import jax
    import jax.numpy as jnp
    B, S, _ = x.shape
    C = jmoe.capacity(S, top_k, n_experts, capacity_factor)
    logits = jnp.asarray(x, jnp.float32) @ jnp.asarray(router, jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_i = jax.lax.top_k(probs, top_k)
    flat_e = top_i.reshape(B, S * top_k)
    onehot = jax.nn.one_hot(flat_e, n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - 1) * onehot, axis=-1)
    return np.asarray(top_i), np.asarray(pos < C)


def moe_expected() -> dict:
    out = {}
    for case, meta in MOE_CASES.items():
        x, p = draw_moe_case(meta)
        kw = dict(n_experts=meta["E"], top_k=meta["k"])
        y, aux = jmoe.moe_ffn(x, p, capacity_factor=meta["capacity_factor"],
                              **kw)
        top_i, keep = jax_routing(x, p["router"],
                                  capacity_factor=meta["capacity_factor"],
                                  **kw)
        assert not keep.all(), f"{case}: no assignment drops"
        out[f"{case}_meta"] = np.array(json.dumps(meta, sort_keys=True))
        out[f"{case}_out"] = np.asarray(y, np.float32)
        out[f"{case}_aux"] = np.float32(aux)
        out[f"{case}_top_i"] = top_i.astype(np.int16)
        out[f"{case}_keep"] = keep
    return out


def export_moe(out_dir: str) -> None:
    t0 = time.perf_counter()
    out = moe_expected()
    path = os.path.join(out_dir, "moe_expected.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path} in {time.perf_counter() - t0:.1f}s: {len(out)} "
          f"arrays, {os.path.getsize(path)} bytes")


#: whisper_expected.npz's recipe: the model, the RandomState seed, the batch,
#: the encoder's frames and the decoder's tokens, the weights' scale (a leaf
#: named in ``norms`` is 1 + norm_scale * N(0, 1), every other leaf, biases
#: included, scale * N(0, 1)), and the encoder rows and logit positions kept
WHISPER_CASE = dict(arch="whisper-tiny", seed=25, B=1, frames=1500,
                    tokens=32, scale=0.02, norm_scale=0.1,
                    norms=["enc_final_norm", "final_norm", "ln", "ln2",
                           "x_ln"],
                    enc_rows=[0, 1, 750, 1499], logit_positions=[0, 8, 16, 31])


def draw_whisper_case(meta: dict, shapes: dict):
    """(frames (B, frames, d) float32, tokens (B, tokens) int32, params) of
    a ``WHISPER_CASE`` recipe, in JAX's tree layout (``shapes``: the tree
    of leaf shapes, the stacked ones with their layer axis first), drawn
    from ``RandomState(seed)`` in this order: the frames, the tokens, the
    top-level leaves by name, each encoder layer's leaves by name (layer 0
    first), each decoder layer's leaves by name (``chip_smoke.py`` draws
    them the same way into the port's model)."""
    rng = np.random.RandomState(meta["seed"])
    d, vocab = shapes["embed"][1], shapes["embed"][0]
    frames = rng.randn(meta["B"], meta["frames"], d).astype(np.float32)
    tokens = rng.randint(0, vocab, (meta["B"], meta["tokens"])).astype(
        np.int32)

    def draw(name, shape):
        w = rng.randn(*shape)
        if name in meta["norms"]:
            return (1.0 + meta["norm_scale"] * w).astype(np.float32)
        return (meta["scale"] * w).astype(np.float32)

    stacked = ("enc_blocks", "blocks")
    params = {name: draw(name, shapes[name])
              for name in sorted(shapes) if name not in stacked}
    for tree in stacked:
        leaves = shapes[tree]["0:attn"]
        out = {name: np.empty(shape, np.float32)
               for name, shape in leaves.items()}
        for n in range(next(iter(leaves.values()))[0]):
            for name in sorted(leaves):
                out[name][n] = draw(name, leaves[name][1:])
        params[tree] = {"0:attn": out}
    return frames, tokens, params


def whisper_shapes(cfg) -> dict:
    """The shapes of JAX's float32 parameter tree of ``cfg``."""
    import jax
    import jax.numpy as jnp
    from repro.models.model import LM as JLM
    specs = JLM(cfg).param_specs(jnp.float32)
    return jax.tree.map(lambda s: tuple(s.shape), specs)


def whisper_expected() -> dict:
    import jax.numpy as jnp
    from repro.models.model import LM as JLM
    meta = WHISPER_CASE
    cfg = get_config(meta["arch"])
    frames, tokens, params = draw_whisper_case(meta, whisper_shapes(cfg))
    jlm = JLM(cfg)
    enc = np.asarray(jlm.encode(params, jnp.asarray(frames)))
    logits, _ = jlm.forward(params, jnp.asarray(tokens),
                            enc_frames=jnp.asarray(frames))
    logits = np.asarray(logits)
    assert np.isfinite(logits).all()
    return {"meta": np.array(json.dumps(meta, sort_keys=True)),
            "enc_out": enc[:, meta["enc_rows"]].astype(np.float32),
            "logits": logits[:, meta["logit_positions"]].astype(np.float32)}


def export_whisper(out_dir: str) -> None:
    t0 = time.perf_counter()
    out = whisper_expected()
    path = os.path.join(out_dir, "whisper_expected.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path} in {time.perf_counter() - t0:.1f}s: {len(out)} "
          f"arrays, {os.path.getsize(path)} bytes")


#: lm_train_expected.npz's recipe: the reduced model, the RandomState seed
#: and scales of its float32 weights (a leaf named in ``norms`` is 1 +
#: norm_scale * N(0, 1), every other leaf scale * N(0, 1)), the token
#: stream's batch and sequence length, the steps and learning rate, and the
#: runs (optimiser, micro-batches, compression)
LM_TRAIN_CASE = dict(arch="yi-6b", reduced=True, seed=31, scale=0.02,
                     norm_scale=0.1, norms=["final_norm", "ln", "ln2"],
                     batch=4, seq=32, steps=2, lr=3e-4,
                     runs={"adamw": ["adamw", 1, False],
                           "adafactor": ["adafactor", 1, False],
                           "sgd_accum2_compress": ["sgd", 2, True]})


def draw_lm_train_case(meta: dict, shapes: dict) -> dict:
    """The float32 parameter tree of an ``LM_TRAIN_CASE`` recipe, in JAX's
    layout (``shapes``: the tree of leaf shapes), each leaf drawn whole from
    ``RandomState(seed)`` in JAX's flatten order (keys sorted at each
    level), as ``chip_smoke.py::draw_lm_train`` draws the port's leaf
    groups."""
    import jax
    rng = np.random.RandomState(meta["seed"])
    paths, tdef = jax.tree_util.tree_flatten_with_path(
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    leaves = []
    for path, shape in paths:
        w = rng.randn(*shape)
        name = path[-1].key
        leaves.append(((1.0 + meta["norm_scale"] * w) if name in meta["norms"]
                       else meta["scale"] * w).astype(np.float32))
    return jax.tree_util.tree_unflatten(tdef, leaves)


def lm_train_expected() -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import reduced
    from repro.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro.models.model import LM as JLM
    from repro.training import lm_step as jstep, optim as jO
    meta = LM_TRAIN_CASE
    cfg = get_config(meta["arch"])
    if meta["reduced"]:
        cfg = reduced(cfg)
    jlm = JLM(cfg)
    params0 = draw_lm_train_case(meta, whisper_shapes(cfg))
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=meta["seq"], global_batch=meta["batch"]))
    out = {"meta": np.array(json.dumps(meta, sort_keys=True))}
    for run, (name, grad_accum, compress) in meta["runs"].items():
        opt = jO.get(name, meta["lr"])
        step = jax.jit(jstep.make_train_step(
            jlm, opt, grad_accum=grad_accum, compress_grads=compress))
        params = jax.tree.map(jnp.asarray, params0)
        state = jstep.make_opt_state(params, opt, compress)
        losses, norms = [], []
        for i in range(meta["steps"]):
            batch = jax.tree.map(jnp.asarray, pipe.global_batch_at(i))
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        out[f"{run}_loss"] = np.array(losses, np.float32)
        out[f"{run}_grad_norm"] = np.array(norms, np.float32)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(str(k.key) for k in path)
            out[f"{run}/{key}"] = np.asarray(leaf, np.float32)
    return out


def export_lm_train(out_dir: str) -> None:
    t0 = time.perf_counter()
    out = lm_train_expected()
    path = os.path.join(out_dir, "lm_train_expected.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path} in {time.perf_counter() - t0:.1f}s: {len(out)} "
          f"arrays, {os.path.getsize(path)} bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=ASSETS)
    ap.add_argument("--skip-mnist", action="store_true",
                    help="only rewrite the fuzz cases")
    ap.add_argument("--only-board", action="store_true",
                    help="only write mnist_board_expected.npz, from the "
                         "committed mnist_ttfs.npz")
    ap.add_argument("--only-transport", action="store_true",
                    help="only write transport_expected.npz, from the "
                         "committed artifacts")
    ap.add_argument("--only-faults", action="store_true",
                    help="only write faults_expected.npz, from the "
                         "committed artifacts")
    ap.add_argument("--only-moe", action="store_true",
                    help="only write moe_expected.npz")
    ap.add_argument("--only-whisper", action="store_true",
                    help="only write whisper_expected.npz")
    ap.add_argument("--only-lm-train", action="store_true",
                    help="only write lm_train_expected.npz")
    a = ap.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    if a.only_board:
        export_board(a.out)
        return 0
    if a.only_transport:
        export_transport(a.out)
        return 0
    if a.only_faults:
        export_faults(a.out)
        return 0
    if a.only_moe:
        export_moe(a.out)
        return 0
    if a.only_whisper:
        export_whisper(a.out)
        return 0
    if a.only_lm_train:
        export_lm_train(a.out)
        return 0
    export_fuzz(a.out)
    if not a.skip_mnist:
        export_mnist(a.out)
    export_board(a.out)
    export_transport(a.out)
    export_faults(a.out)
    export_moe(a.out)
    export_whisper(a.out)
    export_lm_train(a.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
