"""Linear-chain CRF, Viterbi decoding, chunk evaluation.

Counterpart of paddle_tpu/ops/crf_ops.py (parity:
paddle/fluid/operators/{linear_chain_crf_op,crf_decoding_op,
chunk_eval_op}.{h,cc}). The transition parameter's layout is the
reference's (linear_chain_crf_op.h): row 0 the start weights, row 1 the
end weights, rows 2.. the [tag_num x tag_num] transitions. Each JAX
``lax.scan`` over the padded [B, T, ...] batch is a loop over T here,
masked past each sequence's length; the cost is differentiated by
autograd, as JAX's is by its autodiff. No hand-written kernel: the
reference walks these on the CPU too, and they are a small share of a
step (book 07's LSTMs carry it).
"""
import torch

from ..core.registry import register_kernel
from ..lod import SequenceTensor


def _emission(ctx, slot='Emission'):
    st = ctx.input(slot)
    if not isinstance(st, SequenceTensor):
        raise TypeError("%s must be a SequenceTensor" % slot)
    return st


def _labels_dense(label):
    lab = label.data if isinstance(label, SequenceTensor) else label
    if lab.dim() == 3:
        lab = lab[..., 0]
    return lab.long()


def _mask(lengths, T):
    return torch.arange(T, device=lengths.device)[None, :] < \
        lengths[:, None]


@register_kernel('linear_chain_crf')
def _linear_chain_crf(ctx):
    """LogLikelihood = the negative log-likelihood of each sequence's
    label path [B, 1] (a cost, as in the reference: book 07 minimizes
    its mean): the forward algorithm's log partition function less the
    gold path's score."""
    em = _emission(ctx)
    trans = ctx.input('Transition')
    label = _labels_dense(ctx.input('Label'))
    x = em.data                                                 # [B, T, S]
    T = x.shape[1]
    lengths = em.lengths.long()
    start, end, w = trans[0], trans[1], trans[2:]
    mask = _mask(lengths, T)                                    # [B, T]

    alpha = start[None, :] + x[:, 0, :]                         # [B, S]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + w[None, :, :], dim=1) \
            + x[:, t, :]
        alpha = torch.where(mask[:, t:t + 1], nxt, alpha)
    log_z = torch.logsumexp(alpha + end[None, :], dim=1)

    em_score = torch.sum(torch.gather(x, 2, label[..., None])[..., 0] *
                         mask, dim=1)
    trans_score = torch.sum(w[label[:, :-1], label[:, 1:]] * mask[:, 1:],
                            dim=1)
    last = torch.gather(label, 1, (lengths - 1).clamp(min=0)[:, None])[:, 0]
    score = em_score + trans_score + start[label[:, 0]] + end[last]
    ctx.set_output('LogLikelihood', (log_z - score)[:, None])
    # the reference's intermediates, kept for the op's outputs
    ctx.set_output('Alpha', alpha)
    ctx.set_output('EmissionExps', torch.exp(x - torch.max(x)))
    ctx.set_output('TransitionExps', torch.exp(trans - torch.max(trans)))


@register_kernel('crf_decoding')
def _crf_decoding(ctx):
    """Viterbi decode. Without Label: the best path [B, T, 1] (0 past
    each length). With Label: 1 where the label equals the path, else 0
    (crf_decoding_op.h:60-63). A tie between two paths takes the first
    maximum, as ``jnp.argmax`` does."""
    em = _emission(ctx)
    trans = ctx.input('Transition')
    x = em.data
    B, T = x.shape[0], x.shape[1]
    lengths = em.lengths.long()
    start, end, w = trans[0], trans[1], trans[2:]
    mask = _mask(lengths, T)

    delta = start[None, :] + x[:, 0, :]
    back = []                                   # back-pointers of step t+1
    for t in range(1, T):
        cand = delta[:, :, None] + w[None, :, :]                # [B, S, S]
        back.append(torch.argmax(cand, dim=1))
        nxt = torch.amax(cand, dim=1) + x[:, t, :]
        delta = torch.where(mask[:, t:t + 1], nxt, delta)
    # delta is frozen past each length, so the end weights score each
    # sequence at its own last position
    tag = torch.argmax(delta + end[None, :], dim=1)
    path = [tag]
    for t in range(T - 2, -1, -1):
        prev = torch.gather(back[t], 1, tag[:, None])[:, 0]
        tag = torch.where((t + 1) < lengths, prev, tag)
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)
    path = torch.where(mask, path, torch.zeros_like(path))

    label = ctx.input('Label')
    if label is not None:
        out = ((_labels_dense(label) == path) & mask).long()
    else:
        out = path.long()
    ctx.set_output('ViterbiPath', SequenceTensor(out[..., None], lengths))


# ---- chunk evaluation ---------------------------------------------------------
def _chunk_marks(tags, types, valid, scheme, prev_tags, prev_types,
                 prev_valid, next_tags, next_types, next_valid):
    """Start and end flags of the chunks of well-formed tag sequences
    (chunk_eval_op.h ChunkBegin / ChunkEnd)."""
    same_prev = prev_valid & (prev_types == types)
    same_next = next_valid & (next_types == types)
    if scheme == 'iob':       # B=0, I=1
        start = valid & ((tags == 0) | (~same_prev))
        end = valid & ((~same_next) | (next_tags == 0))
    elif scheme == 'ioe':     # I=0, E=1
        start = valid & ((~same_prev) | (prev_tags == 1))
        end = valid & ((tags == 1) | (~same_next))
    elif scheme == 'iobes':   # B=0, I=1, E=2, S=3
        start = valid & ((tags == 0) | (tags == 3))
        end = valid & ((tags == 2) | (tags == 3))
    else:                     # plain: maximal same-type runs
        start = valid & (~same_prev)
        end = valid & (~same_next)
    return start, end


_TAG_COUNTS = {'iob': 2, 'ioe': 2, 'iobes': 4, 'plain': 1}


def _shifted(a, value):
    """(a one step back, a one step on) along T, ``value`` at the ends."""
    p = torch.nn.functional.pad(a, (1, 1), value=value)
    return p[:, :-2], p[:, 2:]


@register_kernel('chunk_eval')
def _chunk_eval(ctx):
    """Precision, recall and F1 over the chunks of a batch, and the
    three counts (chunk_eval_op.h; well-formed sequences;
    excluded_chunk_types respected)."""
    inf = ctx.input('Inference')
    lab = ctx.input('Label')
    scheme = (ctx.attr('chunk_scheme', 'IOB') or 'IOB').lower()
    num_types = int(ctx.attr('num_chunk_types'))
    excluded = set(int(e) for e in ctx.attr('excluded_chunk_types', []))
    ntag = _TAG_COUNTS[scheme]

    st = inf if isinstance(inf, SequenceTensor) else lab
    T = st.data.shape[1]
    seq_mask = _mask(st.lengths.long(), T)

    def analyze(ids):
        ids = _labels_dense(ids)
        types = ids // ntag
        tags = ids % ntag
        valid = seq_mask & (ids < num_types * ntag) & (types < num_types)
        for e in excluded:
            valid = valid & (types != e)
        pt, nt = _shifted(tags, 0)
        ptyp, ntyp = _shifted(types, -1)
        pv, nv = _shifted(valid, False)
        start, end = _chunk_marks(tags, types, valid, scheme, pt, ptyp, pv,
                                  nt, ntyp, nv)
        # each position's chunk end: the first end flag at or after it
        # (T where none follows)
        at = torch.where(end, torch.arange(T, device=ids.device)[None, :],
                         torch.full_like(ids, T))
        chunk_end = torch.flip(torch.cummin(torch.flip(at, [1]), 1).values,
                               [1])
        return start, types, chunk_end

    i_start, i_type, i_end = analyze(inf)
    l_start, l_type, l_end = analyze(lab)
    n_inf = torch.sum(i_start)
    n_lab = torch.sum(l_start)
    correct = torch.sum(i_start & l_start & (i_type == l_type) &
                        (i_end == l_end))
    precision = correct / torch.clamp(n_inf, min=1)
    recall = correct / torch.clamp(n_lab, min=1)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-10)
    ctx.set_output('Precision', precision.reshape(1).float())
    ctx.set_output('Recall', recall.reshape(1).float())
    ctx.set_output('F1-Score', f1.reshape(1).float())
    ctx.set_output('NumInferChunks', n_inf.reshape(1).long())
    ctx.set_output('NumLabelChunks', n_lab.reshape(1).long())
    ctx.set_output('NumCorrectChunks', correct.reshape(1).long())
