"""The JAX package's tests/test_kill9_recovery.py, run unchanged on the port
(tests/torch_suites.py says how)."""

from torch_suites import load

load("test_kill9_recovery", globals())
