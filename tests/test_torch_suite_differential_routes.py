"""The JAX package's tests/test_differential_routes.py, run unchanged on the port
(tests/torch_suites.py says how)."""

from torch_suites import load

load("test_differential_routes", globals())
