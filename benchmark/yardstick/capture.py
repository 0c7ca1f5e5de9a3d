"""Copies of what the timed path produced, taken where it produces them.

A probe wraps one stage of the program (a callable returning a tensor or a
tuple whose first item is the tensor). For the requests and calls chosen
before the window, it copies a few rows of the output into pinned host
buffers made at set-up, without a host sync; the copies are read after the
window. It passes every output through unchanged.
"""

from __future__ import annotations

import torch


class RowProbe:
    def __init__(self, fn, spans, span_name: str, rows: int, shape: tuple[int, ...],
                 slots: int, pin: bool):
        self.fn = fn
        self.spans = span_name and spans
        self.span_name = span_name
        self.rows = rows
        self.buffers = [torch.empty((rows, *shape), dtype=torch.float32, pin_memory=pin)
                        for _ in range(slots)]
        self.taken: dict[int, int] = {}  # request index -> slot
        self.want: dict[int, tuple[int, int]] = {}  # request index -> (call, first row)
        self.request = -1
        self.call = 0

    def start(self, request: int) -> None:
        self.request, self.call = request, 0

    def __call__(self, *args, **kw):
        if self.spans:
            with self.spans.device_span(self.span_name):
                out = self.fn(*args, **kw)
        else:
            out = self.fn(*args, **kw)
        want = self.want.get(self.request)
        if want is not None and want[0] == self.call and self.request not in self.taken:
            slot = len(self.taken)
            x = out[0] if isinstance(out, tuple) else out
            r0 = want[1]
            n = min(self.rows, x.shape[0] - r0)
            self.buffers[slot][:n].copy_(x[r0:r0 + n].float(), non_blocking=True)
            self.taken[self.request] = slot
        self.call += 1
        return out

    def rows_of(self, request: int) -> torch.Tensor | None:
        slot = self.taken.get(request)
        return None if slot is None else self.buffers[slot]
