"""High-level Trainer API.

Counterpart of paddle_tpu/trainer.py (parity:
python/paddle/fluid/trainer.py: Trainer, the Begin/End Epoch/Step
events, build_feed_var_list), in one process on one device.

Resilience: ``train(..., checkpoint_config=CheckpointConfig(dir))``
saves parameters, optimizer accumulators and the trainer's progress
(epoch, step, global step, the Scope's generators) through the atomic
checkpoint protocol (``io.save_checkpoint``), and a fresh
``Trainer().train()`` with the same config restores the newest healthy
serial and skips the steps already done; SIGTERM or SIGINT commits a
checkpoint at the end of the chunk in flight and returns.
``anomaly_guard=AnomalyGuard(policy=...)`` screens feeds, losses and
(optionally) gradient norms and raises, skips the batch or rolls back.

Pipelining: ``prefetch=N`` converts and stages batches N ahead on a
worker (``reader.prefetch``: pinned buffers and a side CUDA stream on
the card); ``steps_per_dispatch=K`` hands K steps at a time to
``Executor.run_chained``; ``sync_interval=M`` reads the loss on the host
every M steps only, the other steps' metrics being device tensors. Each
is bit-equal to the plain loop.

``place=None`` means ``CUDAPlace(0)`` and raises where CUDA is absent
(the JAX package falls back to the CPU; the port never does). Out of
scope, each raising and naming ROADMAP Queue A item 6: the Trainer over
the ParallelExecutor (``parallel=True``, ``zero_stage`` other than None
or 0, ``zero_bucket_bytes`` other than None) and
``PADDLE_TRAINING_ROLE`` (the DistributeTranspiler). Each chunk's
dispatch wall a step goes to the performance observatory
(``perf.publish_step``): the MFU and roofline gauges of the training
program, where its ledger was captured.
"""
import contextlib
import logging
import os
import signal
import threading
import time

import numpy as np
import torch

from . import framework
from . import executor
from . import observability as _obs
from . import io
from . import optimizer as opt_module
from . import data_feeder
from . import unique_name
from .core.lowering import RNG_KEY, RNG_CPU_KEY
from .core.places import CUDAPlace
from .resilience import CheckpointConfig, AnomalyGuard  # noqa: F401 (API)
from .resilience import anomaly as _anomaly
from .resilience import checkpoint as _ckpt
from .resilience import faultinject as _fi

__all__ = ['Trainer', 'BeginEpochEvent', 'EndEpochEvent',
           'BeginStepEvent', 'EndStepEvent', 'check_and_get_place',
           'CheckpointConfig']

_logger = logging.getLogger('paddle_tpu_torch.resilience')

_ITEM_6 = 'is not ported yet (ROADMAP Queue A item 6)'


class BeginEpochEvent(object):
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent(object):
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent(object):
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent(object):
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


def check_and_get_place(place):
    """``place``, or ``CUDAPlace(0)`` when None; raises where CUDA is
    absent instead of falling back to the CPU."""
    if place is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'Trainer: CUDA is not available on this host; pass '
                'place=CPUPlace() to train on the CPU')
        return CUDAPlace(0)
    return place


def _generator_state(gen):
    st = gen.get_state().numpy()
    return {'dtype': str(st.dtype), 'shape': list(st.shape),
            'data': st.ravel().tolist()}


def _set_generator_state(gen, state):
    arr = np.asarray(state['data'], dtype=state['dtype']).reshape(
        state['shape'])
    gen.set_state(torch.from_numpy(arr))


class Trainer(object):
    """``train_func()`` builds the forward and returns [loss, *metrics]
    under this trainer's fresh programs; the optimizer is appended
    here."""

    def __init__(self, train_func, optimizer, param_path=None, place=None,
                 parallel=False):
        self.__stop = False
        if parallel:
            raise NotImplementedError(
                'Trainer(parallel=True): the Trainer over the '
                'ParallelExecutor ' + _ITEM_6)
        self.parallel = parallel
        if not isinstance(optimizer, opt_module.Optimizer):
            raise TypeError(
                "The optimizer should be an instance of Optimizer")
        if "PADDLE_TRAINING_ROLE" in os.environ:
            raise NotImplementedError(
                'PADDLE_TRAINING_ROLE needs the DistributeTranspiler, which '
                + _ITEM_6)

        self.scope = executor.Scope()
        self.startup_program = framework.Program()
        self.train_program = framework.Program()

        # fresh numbering, so a paired Inferencer (which guards too)
        # rebuilds the same parameter names whatever was built before
        with framework.program_guard(self.train_program,
                                     self.startup_program), \
                unique_name.guard():
            program_func_outs = train_func()
            self.train_func_outputs = program_func_outs if isinstance(
                program_func_outs, list) else [program_func_outs]
            self.test_program = self.train_program.clone(for_test=True)
            loss = self.train_func_outputs[0]
            optimizer.minimize(loss)

        self.place = check_and_get_place(place)
        with self._prog_and_scope_guard():
            exe = executor.Executor(self.place)
            exe.run(self.startup_program)
        if param_path:
            with self._prog_and_scope_guard():
                io.load_persistables(executor.Executor(self.place),
                                     dirname=param_path)

    def stop(self):
        self.__stop = True

    def train(self, num_epochs, event_handler, reader=None,
              feed_order=None, checkpoint_config=None,
              anomaly_guard=None, prefetch=0, steps_per_dispatch=1,
              sync_interval=1, zero_stage=None, zero_bucket_bytes=None):
        """Train ``num_epochs`` passes over ``reader``; ``event_handler``
        gets the Begin/End Epoch/Step events.

        ``checkpoint_config``: a resilience.CheckpointConfig: save every
        ``step_interval`` steps and ``epoch_interval`` epochs, and resume
        from the newest healthy serial when one exists.
        ``anomaly_guard``: a resilience.AnomalyGuard screening feeds,
        losses and (optionally) gradient norms each step.
        ``prefetch=N``, ``steps_per_dispatch=K``, ``sync_interval=M``:
        the pipelining knobs (module docstring); ``sync_interval`` is
        forced to 1 under an ``anomaly_guard``, which reads every loss.
        ``zero_stage``: None or 0 (one device), and
        ``zero_bucket_bytes``: None; others raise."""
        if checkpoint_config is not None and not isinstance(
                checkpoint_config, CheckpointConfig):
            raise TypeError('checkpoint_config must be a '
                            'resilience.CheckpointConfig')
        if anomaly_guard is not None and not isinstance(
                anomaly_guard, AnomalyGuard):
            raise TypeError('anomaly_guard must be a '
                            'resilience.AnomalyGuard')
        if int(prefetch) < 0:
            raise ValueError('prefetch must be >= 0')
        if int(steps_per_dispatch) < 1:
            raise ValueError('steps_per_dispatch must be >= 1')
        if int(sync_interval) < 1:
            raise ValueError('sync_interval must be >= 1')
        if zero_stage not in (None, 0):
            raise NotImplementedError(
                'zero_stage=%r: the Trainer\'s ZeRO data parallelism %s'
                % (zero_stage, _ITEM_6))
        if zero_bucket_bytes is not None:
            raise NotImplementedError(
                'zero_bucket_bytes=%r: the Trainer\'s ZeRO data '
                'parallelism %s' % (zero_bucket_bytes, _ITEM_6))
        self._checkpoint_config = checkpoint_config
        self._anomaly_guard = anomaly_guard
        self._prefetch = int(prefetch)
        self._steps_per_dispatch = int(steps_per_dispatch)
        self._sync_interval = int(sync_interval)
        with self._prog_and_scope_guard():
            feeder = self._feeder(self.train_program, feed_order)
            exe = executor.Executor(self.place)
            self._train_loop(event_handler, exe, num_epochs, reader,
                             feeder)

    def test(self, reader, feed_order):
        """The metrics of ``train_func`` averaged over ``reader``'s
        batches on the test program (first element of each, a float)."""
        fetch_list = self.train_func_outputs
        with executor.scope_guard(self.scope):
            feeder = self._feeder(self.test_program, feed_order)
            exe = executor.Executor(self.place)
            accumulated = len(fetch_list) * [0]
            count = 0
            for data in reader():
                outs = exe.run(program=self.test_program,
                               feed=feeder.feed(data),
                               fetch_list=[v.name for v in fetch_list])
                accumulated = [x[0] + float(np.asarray(x[1]).ravel()[0])
                               for x in zip(accumulated, outs)]
                count += 1
            return [x / count for x in accumulated]

    def save_params(self, param_path):
        with self._prog_and_scope_guard():
            exe = executor.Executor(self.place)
            io.save_persistables(exe, dirname=param_path)

    @contextlib.contextmanager
    def _prog_and_scope_guard(self):
        with framework.program_guard(main_program=self.train_program,
                                     startup_program=self.startup_program):
            with executor.scope_guard(self.scope):
                yield

    def _feeder(self, program, feed_order):
        feed_var_list = build_feed_var_list(program, feed_order)
        return data_feeder.DataFeeder(feed_list=feed_var_list,
                                      place=self.place)

    # ---- resilience ------------------------------------------------------------
    def _grad_fetch_names(self):
        """``<param>@GRAD`` names of the train program, for
        AnomalyGuard(monitor_gradients=True)."""
        block = self.train_program.global_block()
        names = []
        for p in block.all_parameters():
            g = p.name + '@GRAD'
            if block._find_var_recursive(g) is not None:
                names.append(g)
        return names

    def _rng_state(self):
        """The Scope's generators' states (the device's, and the host's
        under 'cpu'), JSON-able for the manifest."""
        gen = self.scope.raw(RNG_KEY)
        if gen is None:
            return None
        state = _generator_state(gen)
        cpu = self.scope.raw(RNG_CPU_KEY)
        if cpu is not None:
            state['cpu'] = _generator_state(cpu)
        return state

    def _restore_rng(self, state):
        if not state:
            return
        gen = self.scope.raw(RNG_KEY)
        if gen is not None:
            _set_generator_state(gen, state)
        cpu = self.scope.raw(RNG_CPU_KEY)
        if cpu is not None and state.get('cpu'):
            _set_generator_state(cpu, state['cpu'])

    def _save_progress_checkpoint(self, cfg, epoch_id, step_id,
                                  global_step, exe, force=False):
        """One atomic checkpoint of the persistables and the trainer's
        progress, so a restart repeats nothing and skips nothing.
        ``force`` passes the rate limit: a preemption save commits."""
        state = {'epoch': epoch_id, 'step': step_id,
                 'global_step': global_step, 'rng': self._rng_state()}
        io.save_checkpoint(
            exe, cfg.checkpoint_dir,
            max_num_checkpoints=cfg.max_num_checkpoints,
            save_interval_secs=0 if force else cfg.save_interval_secs,
            main_program=self.train_program, backend=cfg.backend,
            trainer_state=state, scope=self.scope)

    def _maybe_resume(self, cfg, exe):
        """Restore the newest healthy checkpoint (persistables, the
        generators, the counters). Returns (start_epoch, resume_step,
        global_step); resume_step is the last step done in start_epoch
        (-1: none)."""
        if cfg is None or not cfg.resume:
            return 0, -1, 0
        if not io._get_checkpoint_serials(cfg.checkpoint_dir):
            return 0, -1, 0
        cur_dir = io.load_checkpoint(exe, cfg.checkpoint_dir,
                                     main_program=self.train_program,
                                     scope=self.scope)
        state = (_ckpt.read_manifest(cur_dir) or {}).get('trainer_state')
        if not state:
            _logger.warning('auto-resume: %s has no trainer_state; '
                            'restored params only', cur_dir)
            return 0, -1, 0
        self._restore_rng(state.get('rng'))
        _logger.info('auto-resume: restored %s (epoch %d, step %d)',
                     cur_dir, state['epoch'], state['step'])
        return state['epoch'], state['step'], state['global_step']

    def _handle_anomaly(self, err, exe):
        """Apply the guard's policy to a detection; returns 'skip' when
        the batch is to be dropped."""
        guard = self._anomaly_guard
        if guard.policy == 'raise':
            raise err
        if guard.policy == 'rollback_to_checkpoint':
            cfg = self._checkpoint_config
            if cfg is not None and io._get_checkpoint_serials(
                    cfg.checkpoint_dir):
                cur_dir = io.load_checkpoint(
                    exe, cfg.checkpoint_dir,
                    main_program=self.train_program, scope=self.scope)
                state = (_ckpt.read_manifest(cur_dir) or {}).get(
                    'trainer_state') or {}
                self._restore_rng(state.get('rng'))
                _logger.warning('anomaly: rolled parameters back to %s '
                                'after %s', cur_dir, err)
            else:
                _logger.warning('anomaly: rollback requested but no '
                                'checkpoint available; skipping batch '
                                '(%s)', err)
        return 'skip'

    def _feed_stream(self, reader, feeder, prefetch):
        """(examples, feed_dict) pairs; ``prefetch > 0`` converts and
        stages them on a worker, and the consumer's wait for the next is
        ``trainer_host_wait_seconds``."""
        if prefetch > 0:
            from .reader.prefetch import prefetch_feeds
            return prefetch_feeds(reader, feeder, depth=prefetch,
                                  place=self.place)

        def gen():
            for data in reader():
                try:
                    n = len(data)
                except TypeError:
                    n = 0
                yield n, feeder.feed(data)
        return gen()

    def _train_loop(self, event_handler, exe, num_epochs, reader, feeder):
        fetch_names = [v.name for v in self.train_func_outputs]
        guard = self._anomaly_guard
        cfg = self._checkpoint_config
        prefetch = self._prefetch
        chain_k = self._steps_per_dispatch
        sync_interval = 1 if guard is not None else self._sync_interval
        lazy = sync_interval > 1
        grad_names = []
        if guard is not None and guard.monitor_gradients:
            grad_names = self._grad_fetch_names()
        start_epoch, resume_step, global_step = self._maybe_resume(cfg,
                                                                   exe)
        # preemption: SIGTERM/SIGINT set a flag; the loop finishes the
        # chunk in flight, commits a checkpoint at its boundary, journals
        # preempt_save and returns. Handlers go in on the main thread
        # only (signal.signal raises elsewhere).
        preempt = {'sig': None}
        prev_handlers = {}
        if cfg is not None and cfg.preempt_save and \
                threading.current_thread() is threading.main_thread():
            def _on_preempt(signum, frame):
                preempt['sig'] = signum
            for s in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[s] = signal.signal(s, _on_preempt)
        reg = _obs.default_registry()
        m_steps = reg.counter('trainer_steps_total',
                              'optimizer steps completed')
        m_examples = reg.counter('trainer_examples_total',
                                 'training examples consumed')
        m_step_wall = reg.histogram('trainer_step_seconds',
                                    'one training step wall time')
        m_steps_ps = reg.gauge('trainer_steps_per_second',
                               'steps/s over the current train() call')
        m_examples_ps = reg.gauge(
            'trainer_examples_per_second',
            'examples/s over the current train() call')
        m_ttfs = reg.gauge(
            'trainer_time_to_first_step_seconds',
            'train() entry to first completed step (compile included)')
        m_loss = reg.gauge('trainer_last_loss', 'last fetched loss')
        m_host_wait = reg.histogram(
            'trainer_host_wait_seconds',
            'time the train loop blocked on the next host batch (feed '
            'conversion + H2D not overlapped by prefetch)')
        m_dispatch = reg.histogram(
            'trainer_dispatch_seconds',
            'Executor dispatch wall per chunk (1 step, or K chained)')
        loop_t0 = time.monotonic()
        steps_done = examples_done = 0
        perf_fp = self.train_program.fingerprint()
        _obs.emit('train_begin', epochs=num_epochs,
                  start_epoch=start_epoch, global_step=global_step,
                  prefetch=prefetch, steps_per_dispatch=chain_k)
        tspan = _obs.start_span('train/run',
                                parent=_obs.parent_from_env(),
                                epochs=num_epochs,
                                steps_per_dispatch=chain_k)

        def flush(epoch_id, chunk):
            """Run a collected chunk (1 step, or K chained) and each
            member's bookkeeping and events."""
            nonlocal global_step, steps_done, examples_done
            want_fetch = bool(grad_names) or any(
                b.fetch_metrics for _, b, _, _, _ in chunk)
            run_fetches = (fetch_names + grad_names) if want_fetch \
                else []
            gs0 = global_step
            cspan = _obs.start_span('train/chunk', steps=len(chunk),
                                    global_step=gs0) \
                if len(chunk) > 1 else None
            t0 = time.monotonic()
            try:
                if len(chunk) > 1:
                    outs_steps = exe.run_chained(
                        feed_list=[c[2] for c in chunk],
                        fetch_list=run_fetches, async_fetch=lazy)
                else:
                    outs_steps = [exe.run(feed=chunk[0][2],
                                          fetch_list=run_fetches,
                                          async_fetch=lazy)]
            finally:
                if cspan is not None:
                    cspan.end()
            dispatch_wall = time.monotonic() - t0
            m_dispatch.observe(dispatch_wall)
            per_step = dispatch_wall / len(chunk)
            # the live MFU and roofline series: one dict probe when
            # nothing is ledgered, two gauge stores when capture is on
            _obs.perf.publish_step(perf_fp, per_step)
            for (step_id, begin, feed, examples, wait_s), outs in zip(
                    chunk, outs_steps):
                metrics = outs[:len(fetch_names)] if want_fetch else outs
                grad_norm = None
                if guard is not None and want_fetch:
                    # under a guard sync_interval is 1: these are host
                    # values
                    err = None
                    if guard.check_metrics and metrics:
                        err = guard.inspect_loss(metrics[0])
                    if err is None and grad_names:
                        grad_norm = _anomaly.global_norm(
                            outs[len(fetch_names):])
                        err = guard.inspect_grad_norm(grad_norm)
                    if err is not None:
                        # detected after the update ran: 'skip_batch' can
                        # only log, 'rollback' restores the last good
                        # parameters, 'raise' stops
                        self._handle_anomaly(err, exe)
                global_step += 1
                steps_done += 1
                examples_done += examples
                step_wall = wait_s + per_step
                elapsed = time.monotonic() - loop_t0
                m_steps.inc()
                m_examples.inc(examples)
                m_step_wall.observe(step_wall)
                if elapsed > 0:
                    m_steps_ps.set(steps_done / elapsed)
                    m_examples_ps.set(examples_done / elapsed)
                if steps_done == 1:
                    m_ttfs.set(elapsed)
                loss = None
                if metrics and (not lazy or
                                global_step % sync_interval == 0):
                    # with sync_interval=M only every M-th step waits for
                    # the loss
                    loss = _scalar_or_none(metrics[0])
                if loss is not None:
                    m_loss.set(loss)
                if _obs.journal_active():
                    rec = {'epoch': epoch_id, 'step': step_id,
                           'global_step': global_step,
                           'dur_s': round(step_wall, 6),
                           'feed_wait': round(wait_s, 6),
                           'dispatch_s': round(per_step, 6),
                           'examples': examples,
                           'examples_per_s': round(
                               examples_done / elapsed, 3)
                           if elapsed > 0 else 0.0}
                    if len(chunk) > 1:
                        rec['chain'] = len(chunk)
                    if loss is not None:
                        rec['loss'] = loss
                    if grad_norm is not None:
                        rec['grad_norm'] = grad_norm
                    _obs.emit('step_end', **rec)
                    _obs.emit_span('train/step', step_wall,
                                   parent=cspan, step=step_id,
                                   global_step=global_step)
                event_handler(EndStepEvent(epoch_id, step_id, metrics))
            if cfg is not None and (global_step // cfg.step_interval) \
                    > (gs0 // cfg.step_interval):
                # the Scope holds the chunk's end state: the checkpoint
                # records the chunk's last step
                self._save_progress_checkpoint(cfg, epoch_id,
                                               chunk[-1][0], global_step,
                                               exe)

        def commit_preempt(epoch_id, last_step):
            """The preemption commit at a chunk boundary: the Scope holds
            the last flushed chunk's state."""
            sig = preempt['sig']
            self._save_progress_checkpoint(cfg, epoch_id, last_step,
                                           global_step, exe, force=True)
            reg.counter('resilience_preempt_saves_total',
                        'chunk-boundary checkpoints committed on '
                        'SIGTERM/SIGINT').inc()
            _obs.emit('preempt_save', signal=int(sig), epoch=epoch_id,
                      step=last_step, global_step=global_step)
            j = _obs.get_journal()
            if j is not None:
                j.flush()
            _logger.warning(
                'preemption (signal %d): committed checkpoint at chunk '
                'boundary (epoch %d, step %d, global step %d); exiting '
                'cleanly', sig, epoch_id, last_step, global_step)

        try:
            for epoch_id in range(start_epoch, num_epochs):
                event_handler(BeginEpochEvent(epoch_id))
                _obs.emit('epoch_begin', epoch=epoch_id)
                epoch_t0 = time.monotonic()
                epoch_steps0 = steps_done
                stream = self._feed_stream(reader, feeder, prefetch)
                try:
                    step_id = -1
                    chunk = []  # [(step_id, begin, feed, examples, wait_s)]
                    while True:
                        if self.__stop:
                            return
                        t_wait = time.monotonic()
                        try:
                            examples, feed = next(stream)
                        except StopIteration:
                            break
                        wait_s = time.monotonic() - t_wait
                        step_id += 1
                        if epoch_id == start_epoch and \
                                step_id <= resume_step:
                            continue  # done before the restart
                        # where a FaultPlan delivers a preemption at an
                        # exact step
                        _fi.maybe_fault(_fi.SITE_TRAINER_STEP)
                        begin = BeginStepEvent(epoch_id, step_id)
                        event_handler(begin)
                        _obs.emit('step_begin', epoch=epoch_id,
                                  step=step_id, global_step=global_step)
                        m_host_wait.observe(wait_s)
                        if guard is not None and guard.check_feeds:
                            err = guard.inspect_feed(feed)
                            if err is not None and self._handle_anomaly(
                                    err, exe) == 'skip':
                                # the batch never reaches the device; the
                                # events advance, so step counts match a
                                # clean run
                                global_step += 1
                                _obs.emit('step_end', epoch=epoch_id,
                                          step=step_id,
                                          global_step=global_step,
                                          skipped='anomaly')
                                event_handler(EndStepEvent(epoch_id,
                                                           step_id,
                                                           None))
                                continue
                        chunk.append((step_id, begin, feed, examples,
                                      wait_s))
                        if len(chunk) >= chain_k:
                            flush(epoch_id, chunk)
                            chunk = []
                            if preempt['sig'] is not None:
                                commit_preempt(epoch_id, step_id)
                                return
                    if chunk:
                        flush(epoch_id, chunk)  # the epoch's tail
                    if preempt['sig'] is not None:
                        commit_preempt(epoch_id, step_id)
                        return
                finally:
                    close = getattr(stream, 'close', None)
                    if close is not None:
                        close()   # stops the prefetch worker
                event_handler(EndEpochEvent(epoch_id))
                _obs.emit('epoch_end', epoch=epoch_id,
                          steps=steps_done - epoch_steps0,
                          dur_s=round(time.monotonic() - epoch_t0, 6))
                if cfg is not None and \
                        (epoch_id + 1) % cfg.epoch_interval == 0:
                    # "epoch_id + 1, nothing done yet": a resume starts
                    # the next epoch
                    self._save_progress_checkpoint(cfg, epoch_id + 1,
                                                   -1, global_step, exe)
        finally:
            tspan.end(steps=steps_done)
            for s, h in prev_handlers.items():
                signal.signal(s, h)


def _scalar_or_none(value):
    """A fetched metric's first element as a float (a device tensor is
    read here), or None when it has none."""
    try:
        return _anomaly._first_scalar(value)
    except (TypeError, ValueError, IndexError, RuntimeError):
        return None


def build_feed_var_list(program, feed_order):
    if not isinstance(program, framework.Program):
        raise TypeError("The 'program' should be an object of Program")
    if feed_order is None:
        feed_order = [op.outputs['Out'][0]
                      for op in program.global_block().ops
                      if op.type == 'feed']
    if isinstance(feed_order, list):
        return [program.global_block().var(name) for name in feed_order]
    if not isinstance(feed_order, dict):
        raise TypeError(
            "The 'feed_order' should be either None, list or dict.")
    if sorted(feed_order.values()) != list(range(len(feed_order))):
        raise ValueError("The values of 'feed_order' should be a "
                         "permutation of [0, len(feed_order))")
    sorted_pairs = sorted(feed_order.items(), key=lambda item: item[1])
    return [program.global_block().var(name) for name, _ in sorted_pairs]
