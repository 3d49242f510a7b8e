"""The plain float32 reference the benchmark holds the port to. It imports
nothing of the port."""
