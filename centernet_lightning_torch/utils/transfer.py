"""Host <-> card copies that do not make the host wait for the card.

`upload` sends a host array to the device through pinned memory without
blocking (a pageable copy would first wait for the work queued before it);
`host_copies` starts the copies of a dict of device tensors into pinned
host buffers behind an event, so the host waits for those results alone,
not for the work queued after them. On the CPU both are plain moves.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["upload", "host_copies"]


def upload(x, device: torch.device) -> torch.Tensor:
    """`x` (numpy or a tensor) on `device`; from the host to a CUDA device
    through pinned memory, without blocking the host."""
    x = torch.as_tensor(x)
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def host_copies(out: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]:
    """Start the copies of `out` to the host: (host tensors, event). On CUDA
    the copies go into pinned memory without blocking, on the current
    stream, and the event marks their end; the host tensors are valid once
    it has passed. On the CPU there is nothing to copy (event None)."""
    if not any(t.is_cuda for t in out.values()):
        return out, None
    host = {}
    for k, t in out.items():
        host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host[k].copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event
