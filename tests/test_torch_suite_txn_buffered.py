"""The JAX package's tests/test_txn_buffered.py, run unchanged on the port
(tests/torch_suites.py says how)."""

from torch_suites import load

load("test_txn_buffered", globals())
