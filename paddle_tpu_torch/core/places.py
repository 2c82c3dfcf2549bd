"""Device places.

Counterpart of paddle_tpu/core/places.py. Each place names one
``torch.device``: ``CUDAPlace(i)`` is ``cuda:i`` and ``CPUPlace()`` is
the host. A CUDA place on a host without CUDA raises when its device is
asked for; it never stands in for the CPU.
"""
import torch

__all__ = ['CPUPlace', 'CUDAPlace', 'CUDAPinnedPlace']


class Place(object):
    def __init__(self, device_id=0):
        self.device_id = device_id

    def torch_device(self):
        raise NotImplementedError

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)


class CPUPlace(Place):
    def torch_device(self):
        return torch.device('cpu')


class CUDAPlace(Place):
    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDAPlace(%d): CUDA is not available on this host; pass "
                "CPUPlace() to run on the CPU" % self.device_id)
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError("CUDAPlace(%d): only %d CUDA device(s)"
                               % (self.device_id, torch.cuda.device_count()))
        return torch.device('cuda', self.device_id)


class CUDAPinnedPlace(CPUPlace):
    """The reference's page-locked host memory: a host place, as in
    paddle_tpu (``core/places.py``)."""
