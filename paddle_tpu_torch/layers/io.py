"""Data layer and the program readers.

Counterpart of paddle_tpu/layers/io.py (parity:
python/paddle/fluid/layers/io.py). ``data`` declares a feed slot. The
reader layers (``open_recordio_file``, ``open_files``,
``random_data_generator`` and the decorators ``multi_pass``,
``parallel``, ``shuffle``, ``batch``, ``double_buffer``) bind a host-side
source and its decorator chain to a ``ReaderVar``; ``read_file`` returns
its slot variables, which the Executor fills from the reader each run
(``Executor._pull_program_readers``). ``double_buffer(place=
CUDAPlace(0))`` stages each batch on the card on a worker thread. The
distributed layers (``ListenAndServ``, ``Send``, ``Recv``) are not
ported.
"""
from ..layer_helper import LayerHelper
from ..framework import Variable

__all__ = ['data', 'open_recordio_file', 'open_files',
           'random_data_generator', 'multi_pass', 'parallel', 'read_file',
           'shuffle', 'batch', 'double_buffer']


def data(name, shape, append_batch_size=True, dtype='float32', lod_level=0,
         type=None, stop_gradient=True):
    helper = LayerHelper('data', name=name)
    shape = [-1 if s is None else s for s in shape]
    if append_batch_size:
        shape = [-1] + shape
    return helper.create_global_variable(
        name=name, shape=tuple(shape), dtype=dtype,
        stop_gradient=stop_gradient, lod_level=lod_level, is_data=True)


class ReaderVar(Variable):
    """A host-side reader bound into the program: the reader stays on
    the host and the Executor pulls batches from it into the slots."""

    def reset(self):
        """Parity: reader.reset(): restart the decorated stream in every
        scope (stream state is scope-keyed and generation-checked)."""
        self.__dict__['_generation'] = \
            self.__dict__.get('_generation', 0) + 1


def _reader_var(helper, feed_vars, source=None):
    var = ReaderVar(helper.main_program.global_block(),
                    name=helper.name, shape=(), dtype='float32')
    var.feed_vars = list(feed_vars)
    var.source = source
    var.decorators = []
    helper.main_program.global_block().vars[var.name] = var
    return var


def _slots(helper, shapes, dtypes, lod_levels):
    return [helper.create_global_variable(
        name='%s_slot_%d' % (helper.name, i), shape=tuple(shape), dtype=dt,
        lod_level=lod, is_data=True)
        for i, (shape, dt, lod) in enumerate(zip(shapes, dtypes,
                                                 lod_levels))]


def open_recordio_file(filename, shapes, lod_levels, dtypes,
                       pass_num=1, for_parallel=False):
    from ..reader_io import RecordIOSource
    helper = LayerHelper('open_recordio_file')
    return _reader_var(helper, _slots(helper, shapes, dtypes, lod_levels),
                       RecordIOSource(filename, shapes, dtypes, lod_levels,
                                      pass_num))


def open_files(filenames, shapes, lod_levels, dtypes, thread_num=1,
               buffer_size=None, pass_num=1, for_parallel=False):
    from ..reader_io import RecordIOSource
    helper = LayerHelper('open_files')
    return _reader_var(helper, _slots(helper, shapes, dtypes, lod_levels),
                       RecordIOSource(filenames, shapes, dtypes, lod_levels,
                                      pass_num))


def random_data_generator(low, high, shapes, lod_levels,
                          for_parallel=True):
    """Dummy uniform-random reader (parity: reference layers/io.py:362,
    create_random_data_generator): test a network without opening real
    files. float32 only, like the reference."""
    from ..reader_io import RandomDataSource
    helper = LayerHelper('random_data_generator')
    shapes = [tuple(s) if isinstance(s, (list, tuple)) else (s,)
              for s in shapes]
    feed_vars = _slots(helper, shapes, ['float32'] * len(shapes),
                       lod_levels)
    return _reader_var(helper, feed_vars,
                       RandomDataSource(low, high,
                                        [fv.shape for fv in feed_vars],
                                        lod_levels))


def multi_pass(reader, pass_num):
    """Re-iterate the underlying source ``pass_num`` times (parity:
    reference layers/io.py:561, create_multi_pass_reader)."""
    reader.decorators.append(('multi_pass', pass_num))
    return reader


def parallel(reader):
    """Threaded prefetch (parity: reference layers/io.py:566,
    create_threaded_reader): a host thread pulls ahead into a bounded
    queue; sample order is kept."""
    reader.decorators.append(('parallel', None))
    return reader


def shuffle(reader, buffer_size):
    reader.decorators.append(('shuffle', buffer_size))
    return reader


def batch(reader, batch_size):
    reader.decorators.append(('batch', batch_size))
    return reader


def double_buffer(reader, place=None, name=None):
    """Overlap the host's batch production with the device's work
    (parity: reference layers/io.py::double_buffer,
    create_double_buffer_reader). A worker thread pulls ahead into a
    2-deep queue through ``reader.prefetch.PrefetchPipeline``; with
    ``place``, each batch is staged on that device on the worker (a
    pinned buffer, a side stream and an event on the card), so the copy
    is paid ahead too."""
    reader.decorators.append(('double_buffer', place))
    return reader


def read_file(file_obj):
    """The reader's slot Variables; each Executor.run fills them from the
    bound host reader."""
    if len(file_obj.feed_vars) == 1:
        return file_obj.feed_vars[0]
    return list(file_obj.feed_vars)
