"""data — the procedural MNIST stand-in (numpy, byte-identical to repro's) and the synthetic LM token pipeline."""
