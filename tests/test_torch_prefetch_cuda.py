"""The prefetch pipeline's staging on the card, raced on purpose. Marked
``cuda``; it skips where CUDA is absent (the check runs inside the
fixture, never at import). Run on the card with

    python -m pytest --noconftest -q tests/test_torch_prefetch_cuda.py

A slow consumer (a device sleep queued before each read) takes 64
batches through a pipeline of depth 2, reads each on the card and drops
it at once. Each batch's sum, taken on the card, must equal the host's
sum of the batch it was made from. Without the event wait the read
would pass the copy; without ``record_stream`` a dropped batch's memory
would be handed to the next copy before the queued read ran; without
the wait on a pinned buffer's event the worker would refill it under a
copy in flight. Any of them gives a wrong sum.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.reader.prefetch import PrefetchPipeline

pytestmark = pytest.mark.cuda

BATCHES = 64
DEPTH = 2
SHAPE = (512, 2048)        # 4 MiB of f32 a batch
SLEEP_CYCLES = 2_000_000   # ~1 ms at the card's clock


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _batch(i):
    return np.random.RandomState(i).rand(*SHAPE).astype('float32')


def test_staged_batches_survive_a_slow_consumer(cuda):
    want = [float(_batch(i).astype(np.float64).sum())
            for i in range(BATCHES)]
    pipe = PrefetchPipeline(lambda: ({'x': _batch(i)}
                                     for i in range(BATCHES)),
                            depth=DEPTH, place=pt.CUDAPlace(0))
    sums = []
    for feed in pipe:
        torch.cuda._sleep(SLEEP_CYCLES)          # the consumer lags
        sums.append(feed['x'].double().sum())
        del feed                                 # dropped before the read ran
    got = torch.stack(sums).cpu().numpy()
    assert len(got) == BATCHES
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # pinned buffers are reused, not made anew for each batch
    assert pipe.stager.pinned_allocs <= DEPTH + 3
