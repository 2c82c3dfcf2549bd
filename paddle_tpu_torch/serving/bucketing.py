"""Shape bucketing: pad variable client batch sizes into a small set of
power-of-two buckets.

Counterpart of paddle_tpu/serving/bucketing.py. XLA compiles one
executable per input shape, so the JAX package buckets to bound its
compiles; the port runs eagerly and lowers once per (program, feeds,
fetches) whatever the batch, so here buckets bound the set of shapes
the kernels and cuBLAS see (each fused conv plan, each encoded launch,
each cuBLAS heuristic is chosen once per shape) and keep the serving
path identical to the reference's. Padding repeats the last real row by
default, so padded rows stay in-distribution. Pad-row *content* never
affects real rows in a row-independent net; a different batch size can
round differently at the ulp level (a library may pick another kernel
for another M).
"""
import numpy as np

from ..lod import SequenceTensor

__all__ = ['BucketPolicy', 'next_pow2', 'run_bucketed', 'pad_feed',
           'batch_rows']


def next_pow2(n):
    """Smallest power of two >= n (n >= 1)."""
    if n < 1:
        raise ValueError('batch size must be >= 1, got %r' % (n,))
    return 1 << (int(n) - 1).bit_length()


class BucketPolicy(object):
    """Maps a raw batch size to its padded bucket size.

    ``min_bucket``/``max_bucket`` clamp the power-of-two ladder: the
    ceiling is the largest batch a single run may carry (requests larger
    than ``max_bucket`` are rejected by the server's admission control).
    ``pad_mode`` is ``'edge'`` (repeat the last real row; default) or
    ``'zero'``.
    """

    def __init__(self, min_bucket=1, max_bucket=256, pad_mode='edge'):
        if min_bucket < 1 or max_bucket < min_bucket:
            raise ValueError('need 1 <= min_bucket <= max_bucket, got '
                             '%r..%r' % (min_bucket, max_bucket))
        if pad_mode not in ('edge', 'zero'):
            raise ValueError("pad_mode must be 'edge' or 'zero', got %r"
                             % (pad_mode,))
        self.min_bucket = next_pow2(min_bucket)
        self.max_bucket = next_pow2(max_bucket)
        self.pad_mode = pad_mode

    def bucket_for(self, n):
        """The bucket a batch of n rows pads into."""
        if n > self.max_bucket:
            raise ValueError('batch of %d rows exceeds max_bucket=%d'
                             % (n, self.max_bucket))
        return min(self.max_bucket, max(self.min_bucket, next_pow2(n)))

    def buckets(self, upto=None):
        """All bucket sizes up to ``upto`` (default: max_bucket): the
        warmup set."""
        top = self.max_bucket if upto is None else min(
            self.max_bucket, next_pow2(upto))
        b, out = self.min_bucket, []
        while b <= top:
            out.append(b)
            b *= 2
        return out

    def __repr__(self):
        return ('BucketPolicy(min_bucket=%d, max_bucket=%d, pad_mode=%r)'
                % (self.min_bucket, self.max_bucket, self.pad_mode))


def batch_rows(feed):
    """The shared leading (batch) dimension of a dense feed dict, or
    None when the feed is not bucketable (sequence tensors, scalars,
    device tensors, or disagreeing leading dims)."""
    n = None
    if not feed:
        return None
    for val in feed.values():
        if isinstance(val, SequenceTensor):
            return None          # LoD batches don't pad row-wise
        if not isinstance(val, np.ndarray):
            if hasattr(val, 'shape') and not isinstance(val, (list, tuple)):
                return None      # device tensor: don't round-trip to host
            val = np.asarray(val)
        if val.ndim < 1:
            return None
        if n is None:
            n = int(val.shape[0])
        elif int(val.shape[0]) != n:
            return None
    return n


def pad_feed(feed, n, bucket, pad_mode='edge'):
    """Pad every feed's batch dim from n to ``bucket`` rows. A sequence
    feed is padded with copies of its last sequence, whatever the mode
    (a zero-length sequence is no in-distribution row)."""
    if bucket == n:
        return feed
    out = {}
    for name, val in feed.items():
        if isinstance(val, SequenceTensor):
            out[name] = SequenceTensor(
                np.concatenate([val.data] + [val.data[-1:]] * (bucket - n)),
                np.concatenate([val.lengths] +
                               [val.lengths[-1:]] * (bucket - n)))
            continue
        arr = np.asarray(val)
        if pad_mode == 'edge':
            pad = np.repeat(arr[-1:], bucket - n, axis=0)
        else:
            pad = np.zeros((bucket - n,) + arr.shape[1:], dtype=arr.dtype)
        out[name] = np.concatenate([arr, pad], axis=0)
    return out


def _strip(fetch, n, bucket):
    """Slice one fetch back to the real rows; None = not row-aligned."""
    if isinstance(fetch, SequenceTensor):
        if fetch.lengths is None and hasattr(fetch.data, 'shape') and \
                tuple(fetch.data.shape[:1]) == (bucket,):
            return SequenceTensor(fetch.data[:n], None)
        return None              # real LoD output: padding polluted it
    if hasattr(fetch, 'shape') and tuple(fetch.shape[:1]) == (bucket,):
        return fetch[:n]
    return None


def _unsafe_memo(program):
    return program.__dict__.setdefault('_bucket_unsafe', set())


def run_bucketed(exe, program, feed, fetch_list, scope=None, policy=None,
                 return_numpy=True):
    """``Executor.run`` with the batch dim padded to a shape bucket and
    the results stripped back to the real rows.

    Callers get exactly the real rows of the bucket-sized run: pad
    content never bleeds in. Feeds that can't be padded row-wise
    (sequence tensors, device tensors, disagreeing leading dims) and
    programs whose fetches turn out not to be row-aligned (e.g. a mean
    over the batch) fall back to the direct run; the latter is
    remembered per program version so the double run happens at most
    once.
    """
    from .. import executor as _executor
    from .. import profiler as _prof
    scope = scope if scope is not None else _executor.global_scope()
    policy = policy or BucketPolicy()

    def direct():
        return exe.run(program, feed=feed, fetch_list=fetch_list,
                       scope=scope, return_numpy=return_numpy)

    n = batch_rows(feed)
    if n is None or n > policy.max_bucket or \
            program._version in _unsafe_memo(program):
        return direct()
    bucket = policy.bucket_for(n)
    with _prof.serving_span('serving/pad'):
        padded = pad_feed(feed, n, bucket, policy.pad_mode)
    fetches = exe.run(program, feed=padded, fetch_list=fetch_list,
                      scope=scope, return_numpy=return_numpy)
    if bucket == n:
        return fetches
    stripped = [_strip(f, n, bucket) for f in fetches]
    if any(s is None for s in stripped):
        # A fetch is not per-row (reduced over the batch, or carries
        # LoD): the padded rows changed its value. Re-run unpadded for
        # exactness and never pad this program again.
        _unsafe_memo(program).add(program._version)
        return direct()
    return stripped
