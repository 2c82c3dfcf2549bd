"""The performance observatory's report and regression sentinel.

Counterpart of the JAX package's ``tools/perf_report.py``, with its
modes and exit codes::

    python -m paddle_tpu_torch.tools.perf_report --journal run.jsonl
    python -m paddle_tpu_torch.tools.perf_report --smoke --baseline B.json
    python -m paddle_tpu_torch.tools.perf_report --smoke \\
        --update-baseline B.json

- ``--journal``: the per-program table of a recorded run's
  ``perf_ledger`` events (no framework import).
- ``--smoke``: three small programs (an MLP training step under Adam, an
  fc inference step, a conv + batch norm + ReLU region) run through the
  Executor with capture on, their ledgers printed; on the card unless
  ``--device cpu``. With ``--baseline`` the run is diffed against the
  file and the process exits 1 on a regression, naming the program:
  the counted fields (flops, bytes) within 2%, the timing fields, where
  the baseline has them, within ``--tol``.
"""
import argparse
import json
import sys
import time


def journal_ledgers(path):
    """The ``perf_ledger`` events of a journal, one dict a program
    fingerprint (the seal's row, measured updates folded in)."""
    progs = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get('ev') != 'perf_ledger':
                continue
            progs.setdefault(rec.get('fp'), {}).update(
                {k: v for k, v in rec.items()
                 if k not in ('ev', 'run', 't', 'phase') and v is not None})
    return progs


def render(progs, out=None):
    out = out or sys.stdout
    if not progs:
        print('no perf_ledger events (is capture enabled? PTPU_PERF=1 / '
              'observability.perf.enable_capture)', file=out)
        return
    print('perf observatory: %d program(s)' % len(progs), file=out)
    print('  %-16s %-8s %12s %12s %8s %10s %10s %9s'
          % ('program', 'device', 'MFLOP', 'MB accessed', 'MFU',
             'roofline', 'live MB', 'miss'), file=out)
    watermark = 0
    for fp, d in sorted(progs.items(),
                        key=lambda kv: -(kv[1].get('flops') or 0)):
        mfu = d.get('mfu')
        live = d.get('live_bytes') or 0
        watermark += live
        print('  %-16s %-8s %12.3f %12.2f %8s %10s %10.2f %8ss'
              % ((d.get('program') or (fp or '?'))[:16],
                 d.get('backend', '-'), (d.get('flops') or 0) / 1e6,
                 (d.get('bytes_accessed') or 0) / 1e6,
                 '%.4f' % mfu if mfu is not None else '-',
                 d.get('roofline', '-'), live / 1e6,
                 '%.3f' % d.get('compile_wall_s', 0.0)), file=out)
    print('  live bytes summed: %.2f MB' % (watermark / 1e6), file=out)


def _smoke_programs():
    """The three smoke programs, built under ``unique_name.guard()`` so
    their fingerprints (the baseline's keys) are stable."""
    import numpy as np
    import paddle_tpu_torch as pt
    L = pt.layers
    rng = np.random.RandomState(0)
    specs = []
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 11
    with pt.program_guard(main, startup), pt.unique_name.guard():
        img = L.data(name='img', shape=[64], dtype='float32')
        label = L.data(name='label', shape=[1], dtype='int64')
        pred = L.fc(input=L.fc(input=img, size=32, act='relu'), size=10,
                    act='softmax')
        loss = L.mean(L.cross_entropy(input=pred, label=label))
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    specs.append(('mlp_train', main, startup,
                  {'img': rng.randn(16, 64).astype('float32'),
                   'label': rng.randint(0, 10, (16, 1)).astype('int64')},
                  [loss]))
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 12
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = L.data(name='x', shape=[64], dtype='float32')
        y = L.fc(input=L.fc(input=x, size=48, act='relu'), size=8)
    specs.append(('fc_infer', main, startup,
                  {'x': rng.randn(32, 64).astype('float32')}, [y]))
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 13
    with pt.program_guard(main, startup), pt.unique_name.guard():
        im = L.data(name='im', shape=[8, 16, 16], dtype='float32')
        c = L.conv2d(input=im, num_filters=16, filter_size=3, padding=1)
        r = L.relu(L.batch_norm(input=c, is_test=True))
    specs.append(('conv_fuse_infer', main, startup,
                  {'im': rng.randn(4, 8, 16, 16).astype('float32')}, [r]))
    return specs


def run_smoke(steps=8, with_timings=False, device='cuda'):
    """Run the smoke programs with capture on. Returns ({baseline key:
    entry}, [ProgramLedger])."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.observability import perf
    place = pt.CPUPlace() if device == 'cpu' else pt.CUDAPlace(0)
    current, captured = {}, []
    with perf.capture_scope(True):
        for name, main, startup, feed, fetches in _smoke_programs():
            exe = pt.Executor(place)
            scope = pt.Scope()
            exe.run(startup, scope=scope)
            exe.run(main, feed=feed, fetch_list=fetches, scope=scope)
            walls = []
            for _ in range(steps):
                t0 = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=fetches, scope=scope)
                walls.append(time.perf_counter() - t0)
            fp = main.fingerprint()
            ledger = perf.get_ledger(fp)
            if ledger is None:
                continue
            ledger.label = name
            walls.sort()
            perf.publish_step(fp, walls[len(walls) // 2])
            key = perf.PerfBaseline.key(ledger.fingerprint, ledger.shape_sig,
                                        ledger.backend, ledger.mesh)
            current[key] = perf.PerfBaseline.entry_from_ledger(
                ledger, with_timings=with_timings)
            captured.append(ledger)
    return current, captured


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='per-program perf report and regression sentinel')
    ap.add_argument('--journal', help='render a recorded journal')
    ap.add_argument('--smoke', action='store_true',
                    help='run the smoke programs with capture on')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                    help='where --smoke runs (default: the card)')
    ap.add_argument('--baseline',
                    help='diff the smoke run against this baseline; exits '
                    '1 on a regression')
    ap.add_argument('--update-baseline', metavar='PATH',
                    help='write the smoke run as the new baseline')
    ap.add_argument('--with-timings', action='store_true',
                    help='keep step_ms and mfu in baseline entries (one '
                    'machine\'s comparisons only)')
    ap.add_argument('--tol', type=float, default=0.25,
                    help='relative tolerance of step time and MFU')
    ap.add_argument('--steps', type=int, default=8,
                    help='timed steps a smoke program')
    ap.add_argument('--json', action='store_true',
                    help='print JSON instead of the table')
    args = ap.parse_args(argv)
    if args.journal:
        progs = journal_ledgers(args.journal)
        if args.json:
            print(json.dumps(progs, indent=1, sort_keys=True))
        else:
            render(progs)
        return 0
    if not args.smoke:
        ap.error('one of --journal or --smoke is required')
    from paddle_tpu_torch.observability import perf
    current, captured = run_smoke(
        steps=args.steps, with_timings=args.with_timings or
        bool(args.baseline), device=args.device)
    if not captured:
        print('FAIL: the smoke programs captured no ledger', file=sys.stderr)
        return 1
    progs = {l.fingerprint: l.as_dict() for l in captured}
    if args.json:
        print(json.dumps({'programs': progs, 'entries': current},
                         indent=1, sort_keys=True))
    else:
        render(progs)
    if args.update_baseline:
        base = perf.PerfBaseline(args.update_baseline)
        for key, entry in current.items():
            if not args.with_timings:
                entry = {k: v for k, v in entry.items()
                         if k not in ('step_ms', 'mfu')}
            base.put(key, entry)
        base.save()
        print('baseline written: %s (%d entries)'
              % (args.update_baseline, len(base.entries)))
        return 0
    if args.baseline:
        base = perf.PerfBaseline(args.baseline).load()
        if not base.entries:
            print('FAIL: baseline %s missing or empty' % args.baseline,
                  file=sys.stderr)
            return 1
        problems = base.diff(current, tol=args.tol)
        if problems:
            print('PERF REGRESSION (%d problem(s) vs %s):'
                  % (len(problems), args.baseline), file=sys.stderr)
            for p in problems:
                print('  - %s' % p, file=sys.stderr)
            return 1
        print('perf baseline OK (%d program(s) vs %s)'
              % (len(base.entries), args.baseline))
    return 0


if __name__ == '__main__':
    sys.exit(main())
