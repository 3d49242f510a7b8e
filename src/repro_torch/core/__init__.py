"""core — artifact, lowering, the integer LIF/TTFS semantics and the two
runtime families (software reference, packed-event accelerator)."""
