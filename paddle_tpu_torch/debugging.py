"""Failure detection: the debug-mode NaN/Inf guard.

Counterpart of paddle_tpu/debugging.py (parity: the reference's
FLAGS_check_nan_inf per-op tensor checks). The JAX package inserts a
``checkify.check`` after every float-producing op of the compiled step;
the port runs its ops eagerly, so with the guard on
``BlockRunner.run_ops`` tests each float output with ``isfinite`` right
after its op and raises ``FloatingPointError`` naming the op type, the
output and the op's inputs, the message of the JAX package's check. Each
test waits for the device once, so the guard is off unless asked for.

Enable with ``fluid.check_nan_inf(True)`` or the ``nan_guard()``
context manager.
"""
import contextlib

__all__ = ['check_nan_inf', 'nan_checks_enabled', 'nan_guard',
           'NanInfError']


class NanInfError(FloatingPointError):
    """A non-finite output found by the guard; its message names the op,
    the output and the inputs, and it is raised as it is from inside a
    fused region's replay or a control-flow body."""

_CHECK = [False]


def check_nan_inf(enable=True):
    """Turn the per-op NaN/Inf guard on or off; returns the previous
    setting."""
    prev = _CHECK[0]
    _CHECK[0] = bool(enable)
    return prev


def nan_checks_enabled():
    return _CHECK[0]


@contextlib.contextmanager
def nan_guard():
    """NaN/Inf checks on inside the block."""
    prev = check_nan_inf(True)
    try:
        yield
    finally:
        check_nan_inf(prev)
