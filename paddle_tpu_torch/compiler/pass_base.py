"""Pass framework: Pass / PassContext / PassResult / PassRegistry /
PassPipeline.

Counterpart of paddle_tpu/compiler/pass_base.py.

A pass mutates the Program it is given IN PLACE (the pipeline clones
first unless told otherwise) and reports what it did through a
:class:`PassResult`. Every pass declares invariants the pipeline and
tests can rely on:

- ``preserves_semantics``: outputs are bit-identical for any fetch the
  rewrite keeps (dead-op elim, constant folding, elementwise fusion,
  buffer-reuse annotation). Passes that trade bounded numeric drift for
  speed (BN folding re-associates the affine transform) set it False
  and document the tolerance (tests pin <= 1e-5).
- ``idempotent``: ``run(run(p)) == run(p)``: the second application
  reports ``changed=False`` and leaves the program alone.
- ``writes_scope``: the pass writes values into the Scope it is given
  (BN folding rescales the weights in place and adds the fold bias), so
  its output program is only right beside that Scope: the cold-start
  store (fleet/coldstart.py) keeps no program of such a pipeline.
"""
import time

from .. import observability as _obs

__all__ = ['Pass', 'PassContext', 'PassResult', 'PassRegistry',
           'PassPipeline', 'register_pass', 'get_pass',
           'registered_passes']


class PassContext(object):
    """Everything a pass may consult beyond the Program itself.

    ``protected``: names a pass must keep producible/live (fetch targets
    plus anything the caller pins; the executor passes its fetch list).
    ``scope``: runtime values for passes that rewrite weights (BN fold).
    ``stats``: free-form dict shared across the pipeline run.
    """

    __slots__ = ('scope', 'protected', 'stats')

    def __init__(self, scope=None, protected=(), stats=None):
        self.scope = scope
        self.protected = frozenset(protected)
        self.stats = stats if stats is not None else {}


class PassResult(object):
    """What one pass application did to the program."""

    __slots__ = ('pass_name', 'changed', 'ops_removed', 'ops_fused',
                 'ops_folded', 'vars_released', 'note', 'wall_s')

    def __init__(self, pass_name='', changed=False, ops_removed=0,
                 ops_fused=0, ops_folded=0, vars_released=0, note=None):
        self.pass_name = pass_name
        self.changed = changed
        self.ops_removed = ops_removed
        self.ops_fused = ops_fused
        self.ops_folded = ops_folded
        self.vars_released = vars_released
        self.note = note
        self.wall_s = 0.0

    def __bool__(self):
        return bool(self.changed)

    def as_dict(self):
        return {'pass': self.pass_name, 'changed': self.changed,
                'ops_removed': self.ops_removed,
                'ops_fused': self.ops_fused,
                'ops_folded': self.ops_folded,
                'vars_released': self.vars_released,
                'wall_s': self.wall_s, 'note': self.note}

    def __repr__(self):
        return 'PassResult(%s)' % ', '.join(
            '%s=%r' % kv for kv in sorted(self.as_dict().items())
            if kv[1] not in (None, 0, False, 0.0))


class Pass(object):
    """Base class. Subclasses set ``name`` and implement ``run``."""

    name = None
    # Declared invariants (see module docstring).
    preserves_semantics = True
    idempotent = True
    writes_scope = False

    def run(self, program, ctx):
        """Rewrite ``program`` in place; return a :class:`PassResult`."""
        raise NotImplementedError

    def __call__(self, program, ctx=None):
        return self.run(program, ctx or PassContext())

    def __repr__(self):
        return '<Pass %s>' % self.name


_REGISTRY = {}


def register_pass(cls):
    """Class decorator: make the pass constructible by name through the
    registry (PassPipeline specs, tests, tooling)."""
    if not cls.name:
        raise ValueError('pass %r must declare a name' % cls)
    _REGISTRY[cls.name] = cls
    return cls


def get_pass(name, **kwargs):
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError('no compiler pass named %r; registered: %s'
                       % (name, sorted(_REGISTRY)))
    return cls(**kwargs)


def registered_passes():
    return sorted(_REGISTRY)


class PassRegistry(object):
    """Instance-level registry view (the module-level functions above
    are the default instance's API)."""

    def __init__(self):
        self._passes = _REGISTRY

    def get(self, name, **kwargs):
        return get_pass(name, **kwargs)

    def names(self):
        return registered_passes()


class PassPipeline(object):
    """An ordered list of passes, each application timed into its
    :class:`PassResult`.

    ``run`` clones the program by default so caller programs are never
    mutated behind their back (the executor memoizes the optimized clone
    per key); callers that must rewrite in place (``optimize_inference``,
    the ``Inferencer``) pass ``clone=False``.

    Telemetry, as in the JAX package: each pass observes
    ``compiler_pass_seconds{pass=}`` and increments
    ``compiler_ops_eliminated_total`` / ``compiler_ops_fused_total``;
    each application journals a ``compile_pass`` event.

    Sanitizer mode (ANALYSIS.md): ``PassPipeline(..., verify=True)``, or
    env ``PTPU_VERIFY_PASSES=1`` when ``verify`` is left ``None``,
    snapshots the program before every pass and re-runs the static
    verifier after it, raising
    :class:`~paddle_tpu_torch.analysis.PassVerificationError` naming the
    pass and violated invariant on any regression.
    """

    def __init__(self, passes, name='pipeline', verify=None):
        self.name = name
        self.verify = verify
        self.passes = []
        for p in passes:
            if isinstance(p, str):
                p = get_pass(p)
            if not isinstance(p, Pass):
                raise TypeError('PassPipeline takes Pass instances or '
                                'registered names, got %r' % (p,))
            self.passes.append(p)

    def _verify_enabled(self):
        if self.verify is not None:
            return bool(self.verify)
        from ..analysis import verify_passes_enabled
        return verify_passes_enabled()

    def signature(self):
        """Stable token for memo keys: the ordered pass names. Toggling
        a pass in or out changes the signature, so the executor never
        serves a program rewritten under a different pipeline."""
        return tuple(p.name for p in self.passes)

    def run(self, program, scope=None, protected=(), clone=True):
        """Apply every pass in order. Returns ``(program, results)``:
        the (possibly cloned) optimized program plus one
        :class:`PassResult` per pass."""
        if clone:
            program = program.clone()
        ctx = PassContext(scope=scope, protected=protected)
        reg = _obs.default_registry()
        results = []
        sanitize = self._verify_enabled()
        if sanitize:
            # imported here: the analysis imports the passes
            from ..analysis import sanitizer as _san
        for p in self.passes:
            t0 = time.perf_counter()
            if sanitize:
                res = _san.run_checked(p, program, ctx)
            else:
                res = p.run(program, ctx)
            res.wall_s = time.perf_counter() - t0
            reg.histogram('compiler_pass_seconds',
                          'wall seconds per compiler pass application',
                          **{'pass': p.name}).observe(res.wall_s)
            if res.ops_removed or res.ops_folded:
                reg.counter('compiler_ops_eliminated_total',
                            'ops removed by dead-op elimination / '
                            'constant folding').inc(
                                res.ops_removed + res.ops_folded)
            if res.ops_fused:
                reg.counter('compiler_ops_fused_total',
                            'ops merged into fused kernels').inc(
                                res.ops_fused)
            _obs.emit('compile_pass', **{
                'pass': p.name, 'dur_s': round(res.wall_s, 6),
                'changed': bool(res.changed),
                'removed': res.ops_removed + res.ops_folded,
                'fused': res.ops_fused,
                'released': res.vars_released})
            results.append(res)
        return program, results

    def __repr__(self):
        return 'PassPipeline(%s: %s)' % (self.name,
                                         ' -> '.join(self.signature()))
