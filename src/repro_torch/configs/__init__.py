"""The ten LM architecture configurations and the assigned shape cells (copies of ``repro.configs``)."""
