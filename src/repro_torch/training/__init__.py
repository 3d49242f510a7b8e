"""Step factories of the LM zoo (serving and prefill only so far)."""
