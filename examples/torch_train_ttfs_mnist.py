"""End-to-end driver on the PyTorch/CUDA port — the paper's main
experiment, full scale (the counterpart of ``train_ttfs_mnist.py``).

Trains the 784->150 grouped-TTFS classifier on procedural MNIST (60k),
exports the deployment artifact, and reproduces the paper's validation
protocol on the full 10,000-image test set:

  * full-test-set reference<->accelerator prediction agreement (bit-exact),
  * 5-run repeatability (0 mismatches expected),
  * input-sparsity stress sweep (graceful degradation),
  * deployment resource report (the Table-1 analogue).

    PYTHONPATH=src python examples/torch_train_ttfs_mnist.py [--quick]
    PYTHONPATH=src python examples/torch_train_ttfs_mnist.py --quick \\
        --limit 512 --device cpu

``--limit N`` cuts the run further for a smoke test: both splits are made
at N images. The artifact is written under ``--out`` (a new temporary
directory by default). Without a card pass ``--device cpu``.
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import codesign, deploy
from repro_torch.core.accelerator import SNNAccelerator
from repro_torch.core.agreement import full_agreement, repeatability
from repro_torch.data import mnist
from repro_torch.training.ttfs_trainer import train_dense_proxy


def drop_spikes(images: np.ndarray, ratio: float, seed: int = 0) -> np.ndarray:
    """Zero a random fraction of ACTIVE pixels (a dropped input spike is a
    pixel that never fires)."""
    if ratio == 0:
        return images
    rng = np.random.RandomState(seed)
    out = images.copy()
    mask = (rng.rand(*images.shape) < ratio) & (images > 0)
    out[mask] = 0.0
    return out


def export_artifact(model, path, xtr, ytr, device):
    """The deployment artifact, calibrated on the first 8,192 training
    images."""
    return deploy.export(model, path, calib_images=xtr[:8192],
                         calib_labels=ytr[:8192], device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--limit", type=int, default=None,
                    help="make both splits at this many images (a smoke "
                         "test)")
    ap.add_argument("--out", default=None,
                    help="the artifact's directory (default: a new "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    print("== data: procedural MNIST (made locally)")
    sizes = {} if args.limit is None else {"n_train": args.limit,
                                           "n_test": args.limit}
    xtr, ytr = mnist.load("train", **sizes)
    xte, yte = mnist.load("test", **sizes)
    if args.quick:
        xtr, ytr, xte, yte = xtr[:8192], ytr[:8192], xte[:2000], yte[:2000]

    print("== train (dense proxy of grouped readout)")
    res = train_dense_proxy(xtr, ytr, test_images=xte, test_labels=yte,
                            epochs=args.epochs, device=dev)
    print(f"   dense test acc {res.test_acc:.4%} "
          f"({res.steps} steps, {res.wall_s:.0f}s)")

    print("== export single deployment artifact")
    out_dir = args.out or tempfile.mkdtemp(prefix="torch_ttfs_mnist_")
    art = export_artifact(res.model, os.path.join(
        out_dir, "ttfs_mnist_artifact.npz"), xtr, ytr, dev)

    print("== full-test-set agreement (the paper's headline claim)")
    rep = full_agreement(art, xte, yte, chunk=2048, device=dev)
    print(rep.summary())
    assert rep.exact_match

    print("== repeatability (paper §3.3)")
    r = repeatability(art, xte[:2000] if args.quick else xte,
                      yte[:2000] if args.quick else yte, runs=5, chunk=2048,
                      device=dev)
    print(f"   {r['image_run_pairs']} image-run pairs, "
          f"{r['mismatches']} mismatches, stable={r['accuracy_stable']}")
    assert r["mismatches"] == 0

    print("== sparsity stress (paper Fig 3)")
    acc = SNNAccelerator(art, mode="batch", device=dev)
    sparsity = {}
    for ratio in (0.0, 0.25, 0.5, 0.75):
        x = drop_spikes(xte[:4000], ratio)
        a = float(np.mean(acc.forward(x).labels.cpu().numpy()
                          == yte[:4000]))
        sparsity[ratio] = a
        print(f"   drop {ratio:4.0%}: hw TTFS accuracy {a:.4%}")

    print("== deployment resource report (Table-1 analogue)")
    print(codesign.plan(784, 150).table())
    return {"steps": res.steps, "test_acc": res.test_acc,
            "agreement": rep, "repeatability": r, "sparsity": sparsity,
            "fingerprint": art.fingerprint()}


if __name__ == "__main__":
    main()
