"""Run the static program verifier from the command line.

Counterpart of the JAX package's ``tools/analyze_program.py``, with its
arguments, report and exit codes::

    python -m paddle_tpu_torch.tools.analyze_program MODEL_DIR
    python -m paddle_tpu_torch.tools.analyze_program build_net.py
    python -m paddle_tpu_torch.tools.analyze_program MODEL_DIR --json
    python -m paddle_tpu_torch.tools.analyze_program build_net.py --passes

The target is either a ``save_inference_model`` directory (holding
``__model__.json`` with program + feed/fetch names) or a Python file
that BUILDS a program: the file is executed and must either define
``build()`` returning ``(program, feed_names, fetch_names)`` (names may
be empty) or leave a ``paddle_tpu_torch.Program`` bound to one of
``program`` / ``main`` / ``main_program`` (optional ``FEEDS`` /
``FETCHES`` name lists alongside).

Checks: dataflow (use-before-def, fetch reachability), shape/dtype
inference (rank / broadcast / dtype mismatches named per op), sharding
consistency (specs against the partition rules). ``--passes``
additionally runs the default compiler pipeline under the sanitizer
(``PassPipeline(verify=True)``) and reports any invariant violation
with the pass named.

Exit status: 0 when no error-severity diagnostics, 1 on errors (or a
sanitizer violation), 2 on usage/load problems, so CI can gate on it.
Nothing here touches a device.
"""
import argparse
import json
import os
import runpy
import sys

from ..analysis import PassVerificationError, errors_of, verify_program
from ..framework import Program
from ..io import MODEL_FILE, program_from_json


def _load_saved_model(dirname):
    with open(os.path.join(dirname, MODEL_FILE)) as f:
        meta = json.load(f)
    return (program_from_json(meta['program']),
            list(meta.get('feed_names') or ()),
            list(meta.get('fetch_names') or ()))


def _load_builder(path):
    ns = runpy.run_path(path)
    if callable(ns.get('build')):
        prog, feeds, fetches = ns['build']()
        return prog, list(feeds or ()), list(fetches or ())
    for name in ('program', 'main', 'main_program'):
        if isinstance(ns.get(name), Program):
            return (ns[name], list(ns.get('FEEDS') or ()),
                    list(ns.get('FETCHES') or ()))
    raise SystemExit('%s defines neither build() nor a Program bound '
                     'to program/main/main_program' % path)


def _sanitize(program, fetches):
    """Default pipeline under the sanitizer; returns violation
    diagnostics instead of raising so they join the report."""
    from .. import compiler
    from ..compiler.pass_base import PassPipeline
    pipe = PassPipeline(compiler.default_pipeline().passes,
                        name='analyze', verify=True)
    try:
        pipe.run(program, protected=tuple(fetches))
    except PassVerificationError as e:
        return list(e.diagnostics)
    return []


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='statically verify a paddle_tpu_torch program')
    ap.add_argument('target', help='saved-model dir or builder .py')
    ap.add_argument('--json', action='store_true',
                    help='print diagnostics as JSON')
    ap.add_argument('--passes', action='store_true',
                    help='also run the default compiler pipeline under '
                         'the sanitizer')
    ap.add_argument('--feeds', default='',
                    help='comma-separated feed names (override/extend)')
    ap.add_argument('--fetches', default='',
                    help='comma-separated fetch names (override/extend)')
    args = ap.parse_args(argv)

    if os.path.isdir(args.target):
        if not os.path.exists(os.path.join(args.target, MODEL_FILE)):
            print('error: %s has no %s' % (args.target, MODEL_FILE),
                  file=sys.stderr)
            return 2
        program, feeds, fetches = _load_saved_model(args.target)
    elif os.path.isfile(args.target):
        program, feeds, fetches = _load_builder(args.target)
    else:
        print('error: no such file or directory: %s' % args.target,
              file=sys.stderr)
        return 2
    feeds += [n for n in args.feeds.split(',') if n]
    fetches += [n for n in args.fetches.split(',') if n]

    diags = verify_program(program, feeds=tuple(feeds),
                           fetch_names=tuple(fetches))
    if args.passes:
        diags = diags + _sanitize(program, fetches)
    errors = errors_of(diags)

    if args.json:
        print(json.dumps({
            'target': args.target,
            'ops': sum(len(b.ops) for b in program.blocks),
            'feeds': feeds, 'fetches': fetches,
            'errors': len(errors),
            'warnings': len([d for d in diags
                             if d.severity == 'warning']),
            'diagnostics': [d.as_dict() for d in diags],
        }, indent=2, sort_keys=True))
    else:
        print('analyzed %s: %d op(s), %d feed(s), %d fetch(es)'
              % (args.target, sum(len(b.ops) for b in program.blocks),
                 len(feeds), len(fetches)))
        if not diags:
            print('clean: no diagnostics')
        for d in diags:
            print('  ' + d.render())
        print('%d error(s), %d diagnostic(s) total'
              % (len(errors), len(diags)))
    return 1 if errors else 0


if __name__ == '__main__':
    sys.exit(main())
