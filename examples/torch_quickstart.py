"""Quickstart on the PyTorch/CUDA port — the paper's Table-2 workflow, end
to end, through ``repro_torch`` (the counterpart of ``quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py             # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Model definition  ->  snn.SNN / snn.Sequential / snn.Linear / snn.LIF
Artifact export   ->  deploy.export (one shared deployment artifact)
Runtime invoke    ->  make_runtime(art, spec, device=...).forward(x)
                      (registry specs: reference / accelerator-* / board —
                      all three consume the SAME artifact; the board
                      emulator also accounts PL cycles and dynamic energy,
                      the Table-3 analogue)

``--n-train`` and ``--n-test`` (8,192 and 2,048 images by default) size the
procedural MNIST data; the artifact is written under ``--out`` (a new
temporary directory by default). Without a card pass ``--device cpu``: the
CUDA kernels' plain PyTorch versions run instead.
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import deploy
from repro_torch.core.runtimes import make_runtime
from repro_torch.data import mnist
from repro_torch.training.ttfs_trainer import train_dense_proxy


def export_artifact(model, path, xtr, ytr, device):
    """Step 3: the single deployment artifact (weights, thresholds,
    connectivity, grouped TTFS decode metadata, integrity-hashed),
    calibrated on the first 2,048 training images."""
    return deploy.export(model, path, calib_images=xtr[:2048],
                         calib_labels=ytr[:2048], device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-train", type=int, default=8192)
    ap.add_argument("--n-test", type=int, default=2048)
    ap.add_argument("--out", default=None,
                    help="the artifact's directory (default: a new "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    # 1. data (procedural MNIST stand-in, made locally)
    xtr, ytr = mnist.generate(args.n_train, seed=1)
    xte, yte = mnist.generate(args.n_test, seed=2)

    # 2. model definition + training (dense proxy of the grouped TTFS readout)
    result = train_dense_proxy(xtr, ytr, test_images=xte, test_labels=yte,
                               epochs=2, device=dev)
    model = result.model      # snn.SNN(snn.Sequential(Linear(784,150), LIF))
    print(f"trained: dense test accuracy {result.test_acc:.2%}")

    # 3. single-artifact export
    out_dir = args.out or tempfile.mkdtemp(prefix="torch_quickstart_")
    art = export_artifact(model, os.path.join(out_dir,
                                              "quickstart_artifact.npz"),
                          xtr, ytr, dev)
    print(f"exported artifact: threshold={art['thresholds'][0]} "
          f"E_max={art.m('events', 'e_max')} "
          f"blocks={art.m('codesign', 'n_blocks')}x128 lanes")

    # 4. the SAME artifact drives all three runtimes: software reference,
    #    accelerator, and the board-runtime emulator
    reference = make_runtime(art, "reference", device=dev)
    accelerator = make_runtime(art, "accelerator-batch", device=dev)
    board = make_runtime(art, "board", device=dev)
    out_ref = reference(xte)
    out_acc = accelerator(xte)
    out_board = board(xte)

    def host(t):
        return t.cpu().numpy()

    acc = float(np.mean(host(out_acc.labels) == yte))
    print(f"TTFS accuracy {acc:.2%}; three-way agreement on all {len(xte)} "
          "images:")
    agreement = {}
    for name, out in (("accelerator", out_acc), ("board-emu", out_board)):
        agree = np.array_equal(host(out_ref.labels), host(out.labels))
        exact = np.array_equal(host(out_ref.first_spike),
                               host(out.first_spike))
        print(f"  reference<->{name:<12} labels "
              f"{'MATCH' if agree else 'MISMATCH'}, "
              f"spike times {'BIT-EXACT' if exact else 'DIFFER'}")
        assert agree and exact
        agreement[name] = agree and exact

    # 5. the board emulator's cycle/energy account (Table-3 analogue, 80 MHz)
    print(f"board cycle/energy model: {board.last_trace.summary()}")
    lat = make_runtime(art, "board", latency_mode=True, device=dev)
    lat(xte[:256])
    print(f"  TTFS decision latency : {lat.last_trace.summary()}")
    return {"n_images": len(xte), "accuracy": acc, "agreement": agreement,
            "fingerprint": art.fingerprint(),
            "path": os.path.join(out_dir, "quickstart_artifact.npz")}


if __name__ == "__main__":
    main()
