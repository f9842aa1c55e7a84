"""``utils.host_copy``: the asynchronous downloads and uploads of the seg2d
loop. Imports no JAX; the card cases run on a machine with an NVIDIA GPU:
``python -m pytest --noconftest -m cuda tests/test_torch_host_copy.py``.
"""

import numpy as np
import pytest
import torch

from beyondff_tpu_torch.utils.host_copy import HostCopy, to_device


def test_host_copy_on_the_cpu_is_a_copy():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    hc = HostCopy(t)
    assert hc.tensor is t
    got = hc.numpy()
    t += 1  # the copy is the tensor as it was
    np.testing.assert_array_equal(got, np.arange(12, dtype=np.float32).reshape(3, 4))
    assert hc.numpy() is got


def test_to_device_on_the_cpu():
    a = np.arange(6, dtype=np.int64).reshape(2, 3)
    t = to_device(a, torch.device("cpu"))
    assert t.dtype == torch.int64 and np.array_equal(t.numpy(), a)
    assert to_device(a, "cpu", torch.float32).dtype == torch.float32
    assert to_device(t, "cpu") is t


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest --noconftest -m cuda tests/test_torch_host_copy.py")
    return torch.device("cuda")


@pytest.mark.cuda
def test_host_copy_behind_a_long_kernel_equals_blocking_copy(cuda_device):
    """The download queued behind seconds of matmuls, with more queued
    after it: the array equals a blocking ``.cpu()`` of the same tensor,
    read through the copy's own event."""
    torch.manual_seed(0)
    x = torch.randn(4096, 4096, device=cuda_device)
    y = x
    for _ in range(40):
        y = torch.tanh(y @ x / 64)
    hc = HostCopy(y)
    z = y
    for _ in range(40):
        z = torch.tanh(z @ x / 64)  # queued behind the copy
    np.testing.assert_array_equal(hc.numpy(), y.cpu().numpy())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_to_device_does_not_wait_for_the_stream(cuda_device):
    """A pinned non-blocking upload behind queued work: no synchronizing
    call (sync debug mode raises on one), the values arrive."""
    x = torch.randn(2048, 2048, device=cuda_device)
    for _ in range(20):
        x = torch.tanh(x @ x / 64)
    a = np.random.default_rng(0).normal(size=(1000, 4)).astype(np.float32)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = to_device(a, cuda_device)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    np.testing.assert_array_equal(t.cpu().numpy(), a)
