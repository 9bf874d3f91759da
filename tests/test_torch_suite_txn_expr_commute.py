"""The JAX package's tests/test_txn_expr_commute.py, run unchanged on the port
(tests/torch_suites.py says how)."""

from torch_suites import load

load("test_txn_expr_commute", globals())
