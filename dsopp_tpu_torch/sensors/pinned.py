"""Uploads to the card that the host does not wait for.

A copy from pageable host memory (``torch.as_tensor(array).to("cuda")``)
makes the host wait until the stream has drained, that is, until the card
has finished everything queued before it.  :class:`PinnedRing` copies each
host array into one of a few pinned buffers taken in turn; a copy from
pinned memory is queued on the stream and the host goes on.  Before a
buffer is written again, an event recorded after its last copy must report
that copy done: the host polls it (``Event.query``) and never synchronises
the stream.  ``waits`` counts the times a buffer was still in use; with the
card keeping up with the camera there are none.  PyTorch's pinned-memory
allocator does not know of these copies, so a ring that is collected first
waits for its buffers' copies before it lets them go.
"""

from __future__ import annotations

import time
import weakref

import numpy as np
import torch

SLOTS = 3


class PinnedRing:
    """``slots`` pinned host buffers of one shape and type, taken in turn."""

    def __init__(self, slots: int = SLOTS):
        self.slots = slots
        self.waits = 0
        self._buffers = []       # [pinned tensor, its copy's event or None, its numpy view]
        self._key = None
        self._next = 0
        weakref.finalize(self, _settle, self._buffers)

    def stage(self, array):
        """Copy host ``array`` into the next free buffer → (that pinned
        tensor, its event).  The caller queues the buffer's copy to the card
        and records the event right after it (K18's intake does so in its C
        call; :meth:`upload` otherwise)."""
        array = np.asarray(array)
        key = (array.shape, array.dtype)
        if key != self._key:
            for slot in self._buffers:      # a new shape: let the old copies finish
                self._wait(slot)
            dtype = torch.from_numpy(np.empty(0, array.dtype)).dtype
            pinned = [torch.empty(array.shape, dtype=dtype, pin_memory=True)
                      for _ in range(self.slots)]
            self._buffers[:] = [[t, None, t.numpy()] for t in pinned]
            self._key, self._next = key, 0
        slot = self._buffers[self._next]
        self._next = (self._next + 1) % self.slots
        self._wait(slot)
        np.copyto(slot[2], array)
        if slot[1] is None:
            slot[1] = torch.cuda.Event()
            slot[1].record()       # makes the event; the copy records it again
        return slot[0], slot[1]

    def upload(self, array, device) -> torch.Tensor:
        """``array`` as a tensor on ``device`` (a CUDA device), copied through
        the ring without a host wait."""
        pinned, copied = self.stage(array)
        out = pinned.to(device, non_blocking=True)
        copied.record()
        return out

    def _wait(self, slot):
        if slot[1] is not None and not slot[1].query():
            self.waits += 1
            _poll(slot[1])


def _poll(event):
    while not event.query():
        time.sleep(20e-6)


def _settle(buffers):
    """Wait for the copies queued from a collected ring's buffers."""
    for slot in buffers:
        if slot[1] is not None:
            _poll(slot[1])


def to_device(array, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on ``device``; to a card from pinned memory,
    without a host wait (for constants uploaded once)."""
    host = torch.as_tensor(np.ascontiguousarray(array), dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)
