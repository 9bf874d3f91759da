"""Named spans on torch.profiler's timeline.

`with span("vector_search.prep"):` records `tostore.vector_search.prep`
as a `record_function` while a `torch.profiler` is recording, so the span
lands in the same Chrome trace, on the same clock and thread, as the aten
operators, the CUDA calls and the kernels it encloses (`Database.
profile_trace`, or any profiler the caller opens). With no profiler open
it returns one shared no-op context manager: the cost is a function call
and one read of the profiler's own flag, no allocation and no clock read.

Spans of one request nest on the thread that runs it; the engine runs no
request across threads, so nesting is the whole link between a request's
spans.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

PREFIX = "tostore."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager recording `tostore.<name>` while a profiler is
    open, else a no-op."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(PREFIX + name)
    return _OFF
