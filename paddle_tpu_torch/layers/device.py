"""Device placement layer. Counterpart of paddle_tpu/layers/device.py
(parity: python/paddle/fluid/layers/device.py).

Op-level device pinning is a no-op: the whole block runs on the
Executor's place. Kept for API compatibility.
"""
__all__ = ['get_places']


def get_places(device_count=None, device_type=None):
    """The indices of the places a ParallelDo would split over: one per
    CUDA device (``torch.cuda.device_count()``), or one on a host
    without CUDA."""
    import torch
    n = device_count or max(torch.cuda.device_count(), 1)
    return list(range(n))
