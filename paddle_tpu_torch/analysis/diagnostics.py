"""Typed diagnostics for the static program verifier (ANALYSIS.md).

Counterpart of paddle_tpu/analysis/diagnostics.py, copied whole.

A :class:`Diagnostic` is one finding about a Program: where it is (block
index, op index, op type, var names), what it is (a stable ``code``
slug), how bad it is (``severity``), and — for sanitizer findings — the
compiler pass and invariant it violates. :class:`ProgramInvalid` carries
a batch of them as a typed exception, replacing the opaque traceback a
mis-wired program would die with inside an op kernel.
"""

__all__ = ['Diagnostic', 'ProgramInvalid', 'FeedInvalid',
           'PassVerificationError', 'SEVERITIES', 'ERROR', 'WARNING',
           'INFO', 'max_severity', 'errors_of', 'format_diagnostics']

ERROR = 'error'
WARNING = 'warning'
INFO = 'info'
SEVERITIES = (INFO, WARNING, ERROR)
_RANK = {INFO: 0, WARNING: 1, ERROR: 2}


class Diagnostic(object):
    """One typed finding about a Program."""

    __slots__ = ('code', 'severity', 'message', 'block_idx', 'op_index',
                 'op_type', 'var_names', 'pass_name', 'invariant')

    def __init__(self, code, severity, message, block_idx=0,
                 op_index=None, op_type=None, var_names=(),
                 pass_name=None, invariant=None):
        if severity not in _RANK:
            raise ValueError('severity must be one of %s, got %r'
                             % (SEVERITIES, severity))
        self.code = code
        self.severity = severity
        self.message = message
        self.block_idx = block_idx
        self.op_index = op_index
        self.op_type = op_type
        self.var_names = tuple(var_names)
        self.pass_name = pass_name
        self.invariant = invariant

    @property
    def is_error(self):
        return self.severity == ERROR

    def as_dict(self):
        d = {'code': self.code, 'severity': self.severity,
             'message': self.message, 'block': self.block_idx,
             'op_index': self.op_index, 'op_type': self.op_type,
             'vars': list(self.var_names)}
        if self.pass_name is not None:
            d['pass'] = self.pass_name
        if self.invariant is not None:
            d['invariant'] = self.invariant
        return d

    def location(self):
        loc = 'block %d' % self.block_idx
        if self.op_index is not None:
            loc += ' op #%d' % self.op_index
        if self.op_type:
            loc += ' (%s)' % self.op_type
        return loc

    def render(self):
        head = '%s[%s] %s: %s' % (self.severity, self.code,
                                  self.location(), self.message)
        if self.pass_name:
            head += ' [pass=%s invariant=%s]' % (self.pass_name,
                                                 self.invariant)
        return head

    def __repr__(self):
        return 'Diagnostic(%s)' % self.render()


def max_severity(diagnostics):
    """Highest severity in a batch, or None when empty."""
    top = None
    for d in diagnostics:
        if top is None or _RANK[d.severity] > _RANK[top]:
            top = d.severity
    return top


def errors_of(diagnostics):
    return [d for d in diagnostics if d.severity == ERROR]


def format_diagnostics(diagnostics, limit=10):
    lines = [d.render() for d in diagnostics[:limit]]
    extra = len(diagnostics) - limit
    if extra > 0:
        lines.append('... and %d more' % extra)
    return '\n'.join(lines)


class ProgramInvalid(ValueError):
    """Static verification found error-severity diagnostics.

    Raised from ``Executor.run``'s cache-miss path BEFORE lowering
    (ANALYSIS.md), so a rank-mismatched program names its offending op
    instead of dying inside a kernel. ``diagnostics`` holds every
    finding of the failed verify, errors first.
    """

    def __init__(self, diagnostics, message=None):
        diagnostics = sorted(diagnostics, key=lambda d: -_RANK[d.severity])
        self.diagnostics = tuple(diagnostics)
        errs = errors_of(diagnostics)
        if message is None:
            message = ('program verification failed (%d error(s), '
                       '%d diagnostic(s) total):\n%s'
                       % (len(errs), len(diagnostics),
                          format_diagnostics(list(diagnostics))))
        super(ProgramInvalid, self).__init__(message)


class FeedInvalid(ProgramInvalid):
    """A feed value is statically incompatible with the var it feeds
    (rank/dim/dtype-kind mismatch); the diagnostic names the feed slot."""


class PassVerificationError(ProgramInvalid):
    """The pass-pipeline sanitizer caught an invariant violation.

    ``pass_name``/``invariant`` repeat the first error's fields so
    callers (and test asserts) can name the broken pass directly.
    """

    def __init__(self, diagnostics, message=None):
        super(PassVerificationError, self).__init__(diagnostics, message)
        first = next(iter(errors_of(list(diagnostics))), None)
        self.pass_name = getattr(first, 'pass_name', None)
        self.invariant = getattr(first, 'invariant', None)
