"""The atomic checkpoint commit protocol: manifest, CRCs, fsync, verify,
and the Trainer's ``CheckpointConfig``.

Counterpart of paddle_tpu/resilience/checkpoint.py (and the
``CheckpointConfig`` of paddle_tpu/resilience/autoresume.py), in the
same format on disk: a serial is visible only once complete. The payload
goes into a hidden temp dir next to the target, every file and directory
is fsynced, a JSON manifest (``_MANIFEST.json``) with each tensor's
shape, dtype and CRC32 and each file's size and CRC32 is written last,
and the temp dir is ``os.rename``d into place. A kill at any point
leaves the old serials untouched and at most an ignorable ``.tmp_*``
dir. Both packages write and read these npz checkpoints alike, and
``tools/check_checkpoint.py`` verifies either's.

``verify_checkpoint`` recomputes the CRCs against the manifest; it is
the validator ``io.load_checkpoint`` trusts. The sharded backend's
per-shard tables are ROADMAP Queue A item 6: a sharded manifest is
checked by its file CRCs only.
"""
import binascii
import json
import os
import time

import numpy as np

__all__ = ['MANIFEST_FILENAME', 'TMP_PREFIX', 'CheckpointCorruption',
           'CheckpointConfig', 'tensor_crc32', 'file_crc32', 'fsync_tree',
           'write_manifest', 'read_manifest', 'verify_checkpoint']

MANIFEST_FILENAME = '_MANIFEST.json'
MANIFEST_VERSION = 1
# hidden prefix: never matches the checkpoint_<serial> pattern, so
# serial scans and pruning ignore in-flight commits
TMP_PREFIX = '.tmp_'


class CheckpointCorruption(IOError):
    """Manifest/CRC validation failed. ``errors`` lists every mismatch."""

    def __init__(self, dirname, errors):
        super(CheckpointCorruption, self).__init__(
            'corrupt checkpoint %s: %s' % (dirname, '; '.join(errors)))
        self.dirname = dirname
        self.errors = list(errors)


class CheckpointConfig(object):
    """What ``Trainer.train(checkpoint_config=)`` saves and resumes:
    parameters, optimizer accumulators and the trainer's progress every
    ``step_interval`` steps and every ``epoch_interval``-th epoch end,
    into ``checkpoint_dir``, keeping ``max_num_checkpoints`` serials.
    ``save_interval_secs`` rate-limits saves; ``resume=False`` keeps the
    saves but never restores; ``preempt_save`` commits at the chunk
    boundary on SIGTERM/SIGINT. ``backend``: 'auto' and 'npz' write npz;
    'orbax' and 'sharded' raise when a save is made."""

    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3,
                 epoch_interval=1, step_interval=10,
                 save_interval_secs=0, backend='auto', resume=True,
                 preempt_save=True):
        if checkpoint_dir is None:
            raise ValueError('CheckpointConfig needs a checkpoint_dir')
        if epoch_interval < 1 or step_interval < 1:
            raise ValueError('epoch_interval and step_interval must be '
                             '>= 1')
        self.checkpoint_dir = checkpoint_dir
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = epoch_interval
        self.step_interval = step_interval
        self.save_interval_secs = save_interval_secs
        self.backend = backend
        self.resume = resume
        self.preempt_save = preempt_save

    def __repr__(self):
        return ('CheckpointConfig(dir=%r, max=%d, epoch_interval=%d, '
                'step_interval=%d)' % (self.checkpoint_dir,
                                       self.max_num_checkpoints,
                                       self.epoch_interval,
                                       self.step_interval))


def tensor_crc32(arr):
    """CRC32 of an array's raw little-endian payload (C-contiguous)."""
    arr = np.ascontiguousarray(arr)
    return binascii.crc32(arr.tobytes()) & 0xFFFFFFFF


def file_crc32(path, chunk=1 << 20):
    crc = 0
    with open(path, 'rb') as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = binascii.crc32(block, crc)
    return crc & 0xFFFFFFFF


def fsync_tree(root):
    """fsync every file and directory under (and including) ``root`` so
    the rename that follows publishes durable bytes."""
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        for fn in filenames:
            _fsync_path(os.path.join(dirpath, fn))
        _fsync_path(dirpath)


def _fsync_path(path):
    flags = os.O_RDONLY
    if os.path.isdir(path) and hasattr(os, 'O_DIRECTORY'):
        flags |= os.O_DIRECTORY
    try:
        fd = os.open(path, flags)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse a directory fsync
    finally:
        os.close(fd)


def _payload_files(dirname):
    """Every file under ``dirname`` but the manifest and the _SUCCESS
    mark, as sorted relative paths."""
    out = []
    for dirpath, _dirnames, filenames in os.walk(dirname):
        for fn in filenames:
            rel = os.path.relpath(os.path.join(dirpath, fn), dirname)
            if rel in (MANIFEST_FILENAME, '_SUCCESS'):
                continue
            out.append(rel)
    return sorted(out)


def write_manifest(dirname, tensors=None, trainer_state=None,
                   backend=None, serial=None):
    """Record the manifest for a fully written payload in ``dirname``:
    ``tensors`` maps name -> numpy array (shape, dtype and CRC32 taken
    here); every payload file gets its size and CRC32."""
    manifest = {
        'version': MANIFEST_VERSION,
        'backend': backend,
        'serial': serial,
        'saved_at': time.time(),
        'tensors': {},
        'files': {},
    }
    for name, arr in (tensors or {}).items():
        arr = np.asarray(arr)
        manifest['tensors'][name] = {
            'shape': list(arr.shape),
            'dtype': str(arr.dtype),
            'crc32': tensor_crc32(arr),
        }
    for rel in _payload_files(dirname):
        path = os.path.join(dirname, rel)
        manifest['files'][rel] = {
            'size': os.path.getsize(path),
            'crc32': file_crc32(path),
        }
    if trainer_state is not None:
        manifest['trainer_state'] = trainer_state
    path = os.path.join(dirname, MANIFEST_FILENAME)
    with open(path, 'w') as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    return manifest


def read_manifest(dirname):
    """The parsed manifest, or None when absent or unreadable."""
    path = os.path.join(dirname, MANIFEST_FILENAME)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def verify_checkpoint(dirname, check_tensors=True):
    """The mismatches of ``dirname`` against its manifest (an empty list
    means healthy). A dir with a ``_SUCCESS`` mark and no manifest is a
    legacy checkpoint and passes. ``check_tensors`` also re-reads the npz
    payloads and checks each tensor's shape, dtype and CRC."""
    manifest = read_manifest(dirname)
    if manifest is None:
        if os.path.exists(os.path.join(dirname, '_SUCCESS')):
            return []
        return ['missing manifest and _SUCCESS mark']
    errors = []
    on_disk = set(_payload_files(dirname))
    for rel, meta in sorted(manifest.get('files', {}).items()):
        path = os.path.join(dirname, rel)
        if rel not in on_disk:
            errors.append('missing payload file %s' % rel)
            continue
        size = os.path.getsize(path)
        if size != meta['size']:
            errors.append('%s: size %d != manifest %d'
                          % (rel, size, meta['size']))
            continue
        crc = file_crc32(path)
        if crc != meta['crc32']:
            errors.append('%s: crc32 %08x != manifest %08x'
                          % (rel, crc, meta['crc32']))
    for rel in sorted(on_disk - set(manifest.get('files', {}))):
        errors.append('unmanifested payload file %s' % rel)
    if check_tensors and not errors:
        errors.extend(_verify_tensors(dirname, manifest))
    return errors


def _verify_tensors(dirname, manifest):
    """Per-tensor CRC, shape and dtype of npz payloads."""
    tensors = manifest.get('tensors') or {}
    if manifest.get('backend') != 'npz' or not tensors:
        return []
    errors, seen = [], set()
    for rel in manifest.get('files', {}):
        if not rel.endswith('.npz'):
            continue
        try:
            data = np.load(os.path.join(dirname, rel), allow_pickle=False)
        except (OSError, ValueError) as e:
            errors.append('%s: unreadable npz (%r)' % (rel, e))
            continue
        with data:
            for name in data.files:
                meta = tensors.get(name)
                if meta is None:
                    continue
                seen.add(name)
                arr = data[name]
                if list(arr.shape) != list(meta['shape']):
                    errors.append('tensor %s: shape %s != manifest %s'
                                  % (name, list(arr.shape), meta['shape']))
                elif str(arr.dtype) != meta['dtype']:
                    errors.append('tensor %s: dtype %s != manifest %s'
                                  % (name, arr.dtype, meta['dtype']))
                elif tensor_crc32(arr) != meta['crc32']:
                    errors.append('tensor %s: payload crc mismatch' % name)
    for name in sorted(set(tensors) - seen):
        errors.append('tensor %s missing from payload' % name)
    return errors
