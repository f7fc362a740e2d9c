"""One ``torch.profiler`` session for the repo's measuring tools.

The profiler can drop the device records of the kernels that start in the
first milliseconds of its session: in such a session the records it keeps
are the tail of the kernel sequence, and a session around a single launch
can hold no device record at all (``testing/profiler_loss.py`` counts the
lossy sessions with and without a pause; PERF.md has its counts on an
H100).  :func:`profiled` opens the session and waits :data:`LEAD_S` before
the caller's work, so that every kernel the caller launches is recorded.

A session can still lose device records despite the pause (in
``chip_smoke.py``'s ``[batched]`` phase, after its earlier phases, ~10 from
the middle of most sessions): :func:`launch_records` counts a session's
launches from the host's launch calls, and says which of them have no
device record.
"""

from __future__ import annotations

import collections
import contextlib
import re
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


# the CUDA runtime's and driver's calls that put work on the device
LAUNCH_CALL = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|Memcpy|Memset)")


def launch_records(prof) -> dict:
    """A finished session's launches, from the profiler's raw records:

    * ``host``: the host's launch, copy and set calls (:data:`LAUNCH_CALL`),
      ``host_names`` their names' counts and ``threads`` their counts by
      thread;
    * ``device``: the device records (kernels, copies, sets), and ``names``
      their names' counts;
    * ``unmatched_host``: host calls whose correlation id no device record
      carries, and ``unmatched_ops`` the operators that made them ("none"
      for a call made outside an operator: a hand-written kernel's);
      ``unmatched_device``: device records whose correlation id no host call
      of the session carries;
    * ``complete``: both are 0;
    * ``outside_ops``: the host calls made outside any operator (the
      hand-written kernels' launches).

    A session can lose device records, in runs of them, while the host
    calls are all kept: the host calls count the launches.
    """
    cuda = torch.autograd.DeviceType.CUDA
    host, device, ops = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            device.append((e.correlation_id(), e.name()))
        elif LAUNCH_CALL.match(e.name()):
            host.append((e.correlation_id(), e.name(), e.linked_correlation_id(),
                         e.start_thread_id()))
        else:
            ops[e.correlation_id()] = e.name()
    host_ids = {h[0] for h in host}
    device_ids = {c for c, _ in device}
    unmatched = [h for h in host if h[0] not in device_ids]
    unmatched_device = sum(1 for c, _ in device if c not in host_ids)
    return dict(host=len(host), device=len(device), unmatched_host=len(unmatched),
                unmatched_device=unmatched_device,
                complete=not unmatched and unmatched_device == 0,
                host_names=collections.Counter(h[1] for h in host),
                threads=collections.Counter(h[3] for h in host),
                unmatched_ops=collections.Counter(ops.get(h[2], "none") if h[2] else "none"
                                                  for h in unmatched),
                outside_ops=sum(1 for h in host if not h[2] or h[2] not in ops),
                names=collections.Counter(n for _, n in device))
