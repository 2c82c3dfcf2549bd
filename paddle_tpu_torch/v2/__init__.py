"""``paddle_tpu_torch.v2``: the thin compat veneer of the legacy v2
surface. Counterpart of paddle_tpu/v2/__init__.py.

Fluid-era book and benchmark scripts import only the data pieces of v2
(``import paddle.v2 as paddle`` then ``paddle.batch`` /
``paddle.reader`` / ``paddle.dataset``) plus a no-op ``init``. The v2
trainer stack itself is superseded by Fluid and not part of the
surface (ref: python/paddle/v2/__init__.py).
"""
from ..reader import batch  # noqa
from .. import reader  # noqa
from .. import dataset  # noqa


def init(**kwargs):
    """No-op (the reference's v2.init configured the legacy C++ trainer).
    Accepts and ignores use_gpu/trainer_count/... keywords."""
    return None
