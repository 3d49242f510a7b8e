"""repro_torch — the PyTorch/CUDA port of the event-driven SNN deployment stack.

It mirrors ``repro``'s module paths and public names, so the counterpart of
``repro/core/lowering.py`` is ``repro_torch/core/lowering.py``. It imports
``torch`` and numpy and never JAX or the ``repro`` package: the JAX package
is the reference the port is held against, bit for bit, by the
``tests/test_torch_*.py`` suites and by ``chip_smoke.py`` on the card.

Every entry point takes a ``device`` and defaults to ``"cuda"``; without a
card the caller must ask for ``device="cpu"`` explicitly, and then every
hand-written CUDA kernel is replaced by its plain PyTorch version.

    from repro_torch.core.artifact import Artifact
    from repro_torch.serving.snn_engine import SNNServeEngine

    art = Artifact.load("model.npz")
    eng = SNNServeEngine(art, max_batch=64)          # device="cuda"
    labels = eng.classify(images)
"""

__version__ = "0.1.0"
