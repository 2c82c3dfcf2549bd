"""``paddle_tpu_torch.resilience``: what the serving runtime needs of
paddle_tpu/resilience, namely the transient-error retry and the
deterministic fault injection. Checkpoints, anomaly policies and
auto-resume are ROADMAP Queue A item 6."""
from .retry import retry_call, RetryError  # noqa
from . import faultinject  # noqa

__all__ = ['retry_call', 'RetryError', 'faultinject']
