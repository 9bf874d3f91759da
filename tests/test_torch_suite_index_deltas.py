"""The JAX package's tests/test_index_deltas.py, run unchanged on the port
(tests/torch_suites.py says how)."""

from torch_suites import load

load("test_index_deltas", globals())
