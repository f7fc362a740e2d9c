"""One ``torch.profiler`` session for the repo's measuring tools.

The profiler can drop the device records of the kernels that start in the
first milliseconds of its session: in such a session the records it keeps
are the tail of the kernel sequence, and a session around a single launch
can hold no device record at all (``testing/profiler_loss.py`` counts the
lossy sessions with and without a pause; PERF.md has its counts on an
H100).  :func:`profiled` opens the session and waits :data:`LEAD_S` before
the caller's work, so that every kernel the caller launches is recorded.
"""

from __future__ import annotations

import contextlib
import time

import torch

LEAD_S = 0.02


@contextlib.contextmanager
def profiled(activities, lead_s: float = LEAD_S):
    """``torch.profiler.profile(activities=activities)``, entered, after
    ``lead_s`` of waiting."""
    with torch.profiler.profile(activities=activities) as prof:
        time.sleep(lead_s)
        yield prof
