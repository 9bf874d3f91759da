"""The JAX package's tests/test_durability_incremental.py, run unchanged on the port
(tests/torch_suites.py says how)."""

from torch_suites import load

load("test_durability_incremental", globals())
