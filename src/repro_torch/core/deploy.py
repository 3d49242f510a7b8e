"""Export companion to the module graph (paper Table 2: deploy.export /
deploy.gen_config).

The port of ``repro.core.deploy``. ``export`` turns an ``snn.SNN`` into the
single deployment artifact:

    1. quantize weights (fp32 -> symmetric int8),
    2. calibrate integer thresholds on calibration data (a small
       deterministic search maximizing TTFS accuracy — the software side of
       co-design), on the staged kernels: ``spike_matmul`` (kernel 4) for
       the currents, then per candidate ``lif_fused`` (kernel 5) and
       ``ttfs_decode`` (kernel 6),
    3. calibrate the event-buffer depth E_max,
    4. run the deployment planner and emit the padded block layout
       (connectivity descriptor),
    5. write one .npz with weights (fp32 + int8), thresholds, connectivity
       descriptors, grouped decoding metadata, and integrity manifest.

The same float weights export to the same artifact as the JAX package's
exporter: the same fingerprint, array bytes and meta. Three places hold it
to that. The quantiles stay ``np.quantile`` on the host (float64, as JAX
takes them). The calibration accuracy is the float32 value XLA computes for
``jnp.mean(pred == labels)``: the count times the float32 reciprocal of the
image count (``_mean_accuracy``). And the candidates are tried in JAX's
order, keeping the first strictly better one.

On a CUDA device the kernels launch or raise; on the CPU their plain
versions run (dispatch by the tensors' device, as everywhere in the port).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import codesign, events, quant, snn, ttfs
from repro_torch.core.artifact import Artifact
from repro_torch.core.lowering import lower, resolve_device
from repro_torch.kernels.lif import ops as lif_ops
from repro_torch.kernels.spike_matmul import ops as smm_ops
from repro_torch.kernels.ttfs_decode import ops as dec_ops


def gen_config(model: snn.SNN) -> dict:
    """Deployment metadata for a model (no arrays) — inspection/debug aid."""
    lin = model.linear_layers()
    if len(lin) != 1:
        raise NotImplementedError(
            "the deployed path supports the paper's topology: exactly one "
            "Linear stage followed by a LIF stage (deeper/conv models are the "
            "paper's stated future work)")
    lif = model.lif_layers()[0] if model.lif_layers() else snn.LIF()
    leak_shift = quant.leak_shift_from_tau(lif.spec.tau)
    return {
        "model": {"topology": "linear-ttfs", "n_in": lin[0].in_features,
                  "n_out": lin[0].out_features},
        "encode": {"T": model.encode_t, "x_min": model.x_min},
        "lif": {"leak_shift": leak_shift, "v_init": 0},
        "readout": {"n_groups": model.readout.n_groups,
                    "per_group": model.readout.per_group,
                    "fallback": model.readout.fallback},
    }


def encode_images(images: np.ndarray, T: int, x_min: float,
                  device: torch.device) -> torch.Tensor:
    """(B, n_in) images -> (B, n_in) int32 spike times on ``device``
    (float32 encode)."""
    x = torch.from_numpy(np.asarray(images, np.float32)).to(device)
    return ttfs.encode_ttfs(x, T, x_min)


def calibration_currents(w_int8: np.ndarray, T: int, x_min: float,
                         images: np.ndarray, device: torch.device
                         ) -> torch.Tensor:
    """(B, T, n_out) int32 synaptic currents of the calibration images:
    encode -> raster -> the exact int8 product (``spike_matmul``). They
    depend on neither the leak nor the thresholds, so a calibration computes
    them once for all its candidates."""
    raster = ttfs.frames_from_times(encode_images(images, T, x_min, device),
                                    T)
    return smm_ops.spike_matmul(raster, torch.from_numpy(w_int8).to(device))


def _mean_accuracy(correct: int, n: int) -> float:
    """``float(jnp.mean(pred == labels))`` as XLA computes it on the CPU: a
    float32 sum (exact below 2**24) times the float32 reciprocal of ``n``
    (XLA turns the division by a constant into that product). It is stored
    in the artifact's meta, which the fingerprint hashes, so a float64 or a
    float32 division would change the artifact wherever ``n`` is not a
    power of two."""
    return float(np.float32(correct) * (np.float32(1) / np.float32(n)))


def _ttfs_accuracy(currents: torch.Tensor, thr: torch.Tensor,
                   leak_shift: int, labels: torch.Tensor, n_groups: int,
                   per_group: int, fallback: str) -> float:
    """TTFS accuracy of one threshold candidate on (B, T, N) currents: LIF
    over T (``lif_fused``, on the currents' (T, B, N) view), then the
    grouped decode with sentinel T (``ttfs_decode``)."""
    T = currents.shape[1]
    res = lif_ops.lif_fused(currents.movedim(1, 0), thr, leak_shift)
    pred = dec_ops.ttfs_decode(res.first_spike, res.v_final,
                               n_groups=n_groups, per_group=per_group,
                               sentinel=T, fallback=fallback)
    return _mean_accuracy(int((pred == labels).sum()), labels.shape[0])


def _per_neuron_peaks(currents: torch.Tensor, ls: int) -> np.ndarray:
    """(B, N) per-neuron peak membrane over T at leak ``ls``, int32: the
    recurrence ``v - (v >> ls) + i_t`` with a running max, on the currents'
    device (no kernel computes the peak)."""
    v = torch.zeros_like(currents[:, 0])
    peak = None
    for t in range(currents.shape[1]):
        v = v - (v >> ls) + currents[:, t]
        peak = v if peak is None else torch.maximum(peak, v)
    return peak.cpu().numpy()


def calibrate_thresholds(w_int8: np.ndarray, meta: dict,
                         calib_images: np.ndarray, calib_labels: np.ndarray,
                         quantiles=(0.85, 0.9), scales=(0.7, 0.8, 0.9), *,
                         device: str | torch.device = "cuda") -> np.ndarray:
    """Per-neuron threshold calibration: theta_n = quantile_q over
    calibration images of neuron n's peak membrane, scaled; the (q, scale,
    leak) triple with the best calibration TTFS accuracy wins (the first,
    on ties). The chosen leak_shift is written back into the metadata (the
    artifact carries the deployed dynamics). Deterministic; returns
    per-neuron int32."""
    dev = resolve_device(device)
    T = meta["encode"]["T"]
    ro = meta["readout"]
    currents = calibration_currents(w_int8, T, meta["encode"]["x_min"],
                                    calib_images, dev)
    labels = torch.from_numpy(np.asarray(calib_labels)).to(dev)
    best = (None, -1.0, meta["lif"]["leak_shift"])
    for ls in sorted({meta["lif"]["leak_shift"], 31}):
        peaks = _per_neuron_peaks(currents, ls)
        for q in quantiles:
            base = np.quantile(peaks, q, axis=0)
            for s in scales:
                thr = np.maximum(1, base * s).astype(np.int32)
                acc = _ttfs_accuracy(currents, torch.from_numpy(thr).to(dev),
                                     ls, labels, ro["n_groups"],
                                     ro["per_group"], ro["fallback"])
                if acc > best[1]:
                    best = (thr, acc, ls)
    meta["lif"]["leak_shift"] = int(best[2])
    meta["lif"]["calibration"] = {"method": "per-neuron-peak-quantile",
                                  "calib_accuracy": float(best[1])}
    return best[0]


def export(model: snn.SNN, path: str | None = None, *,
           calib_images: np.ndarray, calib_labels: np.ndarray,
           e_max_headroom: float = 1.0,
           device: str | torch.device = "cuda") -> Artifact:
    dev = resolve_device(device)
    meta = gen_config(model)
    lin = model.linear_layers()[0]
    if lin.w is None:
        raise RuntimeError("model has no trained parameters; train first")
    w_f32 = lin.w.detach().cpu().numpy().astype(np.float32)
    w_int8, scale = quant.quantize_weights(w_f32)
    meta["quant"] = {"scale": scale, "bits": 8, "scheme": "symmetric-per-tensor"}

    thr = calibrate_thresholds(w_int8, meta, calib_images, calib_labels,
                               device=dev)

    T = meta["encode"]["T"]
    times = encode_images(calib_images, T, meta["encode"]["x_min"], dev)
    e_max = events.calibrate_e_max(times.cpu().numpy(), T,
                                   headroom=e_max_headroom)
    meta["events"] = {"e_max": e_max, "pad": events.PAD}

    report = codesign.plan(lin.in_features, lin.out_features)
    meta["codesign"] = {"lane": report.lane, "n_pad": report.n_pad,
                        "n_blocks": report.n_blocks,
                        "vmem_util": report.vmem_util,
                        "limiter": report.limiter}
    gids = ttfs.group_map(meta["readout"]["n_groups"], meta["readout"]["per_group"])
    layout = codesign.blocked_layout(w_int8, thr, gids, report.lane)

    arrays = {"w_float": w_f32, "w_int8": w_int8, "thresholds": thr,
              "group_ids": gids, **layout}
    art = Artifact(meta, arrays)
    # calibration gate: every export must lower (uncached: save() is about
    # to restamp the fingerprint), so a malformed export fails HERE, at the
    # producer, not inside whichever runtime first consumes it
    lower(art, device=dev, cache=False)
    if path is not None:
        art.save(path)
    else:
        art.meta["manifest"] = {k: "" for k in arrays}  # filled on save
    return art
