"""Named ranges of the port's work, recorded only while a torch profiler
runs.

    with span("train.optimizer"):
        state.tx.update(params, grads)

While `torch.profiler.profile` (or `torch.autograd.profiler.profile`)
records, a span is a range of the profiler's own kind: an op of its name
on the host, on the time line the trace maps its device kernels onto, in
every trace an operator takes (`cli.train --profile`, the `--trace` of
`cli.profile_serve` and `cli.profile_train`). A kernel launched inside it
with no op of its own between (a ctypes kernel) is linked to it. Without
a profiler a span costs one flag read and returns a shared null context.

The range is an op (`RecordScope.FUNCTION`), not a user annotation
(`torch.profiler.record_function`): a user annotation also gets a copy on
the device's timeline that spans its kernels and the gaps between them,
which a trace reader that counts every device event as work would count as
a kernel and as busy time. Autograd's worker threads inherit the
profiler's state, so a span opened in a backward is recorded there.

Spans: `api.call` (`CenterNetPredictor.gather_detection2d`) around
`api.prepare` (upload and preprocess), `api.forward`, `api.decode` and
`api.to_host` (the copies of the top-k to the host); `train.step`
(`train/state.py:make_train_step`) around `train.cast`, `train.forward`,
`train.loss`, `train.backward` and `train.optimizer`; `dcn.recompute`
(`ops/dcn.py:twin_vjp`, the DCN kernels' backward); `dcn.exact`
(`ops/dcn.py:exact_taps`, the exact DCN engine's sampling, counted in
`exact_taps.calls`); `neck.dlaup` (`models/necks.py:DLAUp.forward`);
`int8_conv.<stage>` (`quantize.py`).
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records a range `name` while a profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
