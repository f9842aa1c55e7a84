"""Asynchronous device-to-host downloads and host-to-device uploads.

:class:`HostCopy` is the port's ``jax.Array.copy_to_host_async`` followed by
``np.asarray``: the download of a CUDA tensor starts into a pinned host
buffer on the current stream as soon as the tensor is made, and a
``torch.cuda.Event`` recorded behind it is the only thing :meth:`HostCopy.
numpy` waits on, never the stream or the device. Work queued after the copy
goes on running while the host reads the result, so a scene loop can
dispatch batch t+1 before it reads batch t.

:func:`to_device` is the other direction: a blocking ``torch.as_tensor(...,
device="cuda")`` of pageable host memory synchronizes the whole stream
(PyTorch copies from pageable memory and then waits for the stream), which
puts the host back behind every kernel in flight. The array is copied into
a pinned buffer instead and uploaded with ``non_blocking=True``; PyTorch's
pinned-memory allocator keeps the buffer from reuse until the copy has run.

On the CPU both are plain copies, so the CPU tests run the same code.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class HostCopy:
    """A download of ``tensor`` started on the current stream.

    ``tensor`` is kept as :attr:`tensor`, the device source (a CUDA
    tensor's memory is stream-ordered, so nothing queued later on the same
    stream can overwrite it before the copy has run). The pinned buffer is
    read only after its event has completed, and :meth:`numpy` returns the
    same array on every call."""

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        self._array: Optional[np.ndarray] = None
        self._event: Optional[torch.cuda.Event] = None
        if tensor.is_cuda:
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(tensor.device))
        else:
            self._host = tensor.detach().clone()

    def numpy(self) -> np.ndarray:
        """The downloaded array: waits on this copy's event only."""
        if self._array is None:
            if self._event is not None:
                self._event.synchronize()
            self._array = self._host.numpy()
        return self._array


def to_device(array, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array (or CPU tensor) on ``device`` without synchronizing the
    stream: pinned and copied with ``non_blocking=True`` on a CUDA device,
    ``torch.as_tensor`` elsewhere. A tensor already on a device moves with
    ``.to``."""
    t = torch.as_tensor(array, dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
