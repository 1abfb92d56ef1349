"""Named spans at the port's layer boundaries, for ``torch.profiler``.

``with span("moe.route"): ...`` opens the profiler range
``repro_torch.moe.route`` while a profiler is recording, and is one shared
no-op context otherwise: spans are recorded exactly when the process is
profiled, with no setting of their own. The profiler keeps them in its
own buffer, stamped on the clock of the device's kernels and copies, each
nested in the span open around it on its thread, and writes them with
its Chrome trace under the category ``user_annotation``.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """The range ``repro_torch.<name>`` while a profiler records, else the
    shared no-op (a ``record_function`` costs over ten times the check even
    when nothing records)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)
