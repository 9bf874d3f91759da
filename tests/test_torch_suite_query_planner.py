"""The JAX package's tests/test_query_planner.py, run unchanged on the port
(tests/torch_suites.py says how)."""

from torch_suites import load

load("test_query_planner", globals())
