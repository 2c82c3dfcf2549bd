"""convert_reader_to_recordio_file(s).

Counterpart of paddle_tpu/recordio_writer.py (parity:
python/paddle/fluid/recordio_writer.py). Writes the same bytes as the
JAX package for the same batches: PTRC records are pickles of plain
numpy values (protocol 4), never of a class of either package.
"""
import pickle

import numpy as np

from .lod import _host
from .reader_io import RecordIOWriter

__all__ = ['convert_reader_to_recordio_file',
           'convert_reader_to_recordio_files']


def convert_reader_to_recordio_file(filename, reader_creator, feeder,
                                    compressor=None, max_num_records=1000,
                                    feed_order=None, layout='ptrc'):
    """``layout='ptrc'`` (default) writes the fast chunk format;
    ``layout='reference'`` writes the reference fluid recordio layout
    (recordio_compat: snappy-framed chunks of LoDTensor-bundle records),
    which the reference runtime reads."""
    if feed_order is None:
        feed_order = feeder.feed_names
    counter = 0
    if layout == 'reference':
        from .recordio_compat import (ReferenceRecordIOWriter, SNAPPY,
                                      pack_lod_tensor_record)
        from .lod import SequenceTensor
        comp = SNAPPY if compressor is None else compressor
        with ReferenceRecordIOWriter(filename, comp,
                                     max_num_records) as writer:
            for batch in reader_creator():
                res = feeder.feed(batch)
                tensors = []
                for name in feed_order:
                    v = res[name]
                    if isinstance(v, SequenceTensor):  # packed rows + lod
                        rows = v.to_dense_rows()
                        offs = [[0] + list(np.cumsum(
                            np.asarray(lv, dtype='int64')))
                            for lv in v.recursive_sequence_lengths()]
                        tensors.append((rows, offs))
                    else:
                        tensors.append(_host(v))
                writer.write(pack_lod_tensor_record(tensors))
                counter += 1
        return counter
    with RecordIOWriter(filename, compressor, max_num_records) as writer:
        for batch in reader_creator():
            res = feeder.feed(batch)
            slots = [_serialize_slot(res[name]) for name in feed_order]
            writer.write(pickle.dumps(slots, protocol=4))
            counter += 1
    return counter


def _serialize_slot(v):
    """One feed value as a picklable PTRC slot. A SequenceTensor is
    tagged so its LoD survives the round trip (the padded data alone
    loses it; the reader's _rebuild_slots inverts this)."""
    if getattr(v, 'lengths', None) is not None:
        return ('__seq__', _host(v.data), _host(v.lengths),
                None if v.sub_lengths is None else _host(v.sub_lengths))
    return _host(v.data) if hasattr(v, 'lengths') else _host(v)


def convert_reader_to_recordio_files(filename, batch_per_file,
                                     reader_creator, feeder,
                                     compressor=None, max_num_records=1000,
                                     feed_order=None):
    """One PTRC file of ``batch_per_file`` batches each, named
    ``<stem>-00000.<ext>`` and on; a trailing group smaller than
    ``batch_per_file`` is not written, as in the reference."""
    if feed_order is None:
        feed_order = feeder.feed_names
    f_name, f_ext = filename.rsplit('.', 1) if '.' in filename else \
        (filename, 'recordio')
    lines = []
    f_idx = 0
    counter = 0
    for batch in reader_creator():
        lines.append(batch)
        if len(lines) == batch_per_file:
            filename = "%s-%05d.%s" % (f_name, f_idx, f_ext)
            with RecordIOWriter(filename, compressor,
                                max_num_records) as writer:
                for l in lines:
                    res = feeder.feed(l)
                    slots = [_serialize_slot(res[n]) for n in feed_order]
                    writer.write(pickle.dumps(slots, protocol=4))
                    counter += 1
                lines = []
                f_idx += 1
    return counter
