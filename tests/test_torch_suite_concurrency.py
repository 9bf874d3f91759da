"""The JAX package's tests/test_concurrency.py, run unchanged on the port
(tests/torch_suites.py says how)."""

from torch_suites import load

load("test_concurrency", globals())
