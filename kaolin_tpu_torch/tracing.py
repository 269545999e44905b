"""Named spans at the package's render entry points, for ``torch.profiler``.

A span is a ``torch.profiler.record_function`` range named
``kaolin.<public name>``, one a call, nested as the calls are. Profiled
with the CPU and CUDA activities, it lies on the same timeline as the
kernels its calls launch, so a trace can put the device's time down to
the entry point that launched it (a backward kernel through the forward
op of its autograd node). A span is open exactly while a profiler
records: otherwise :func:`span` returns one shared null context after a
single check, and makes nothing.

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as p:
        loss = fit_step()          # kaolin.rasterize, kaolin.face_normals..
"""

import contextlib

import torch

__all__ = ['span']

_OFF = contextlib.nullcontext()


def span(name):
    """A context that records the range ``name`` while a profiler
    records, else the shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
