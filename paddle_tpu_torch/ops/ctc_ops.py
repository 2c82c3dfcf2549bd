"""CTC loss, greedy decoding, edit distance.

Counterpart of paddle_tpu/ops/ctc_ops.py (parity:
paddle/fluid/operators/{warpctc_op,ctc_align_op,edit_distance_op}.*).
CTC is the log-space alpha recursion of the JAX kernel, a loop over the
padded time steps masked past each length, differentiated by autograd.
Its log-sum-exp keeps the JAX kernel's -1e30 floor and order of sums,
but feeds the log a 1 where every term is at the floor: the JAX
kernel's ``where`` takes log(0) there, whose gradient 0 / 0 makes every
gradient of its loss NaN (ROADMAP Queue C); here they are finite.
"""
import torch

from ..core.registry import register_kernel
from ..lod import SequenceTensor

_NEG = -1e30


def _logsumexp2(a, b):
    m = torch.maximum(a, b)
    floor = m <= _NEG / 2
    m_safe = torch.where(floor, torch.zeros_like(m), m).detach()
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe)
    out = m_safe + torch.log(torch.where(floor, torch.ones_like(s), s))
    return torch.where(floor, torch.full_like(out, _NEG), out)


def _seq(ctx, slot):
    v = ctx.input(slot)
    if not isinstance(v, SequenceTensor):
        raise TypeError('%s needs a SequenceTensor %s' % (ctx.op.type, slot))
    return v


def _ids(st):
    d = st.data
    if d.dim() == 3:
        d = d[..., 0]
    return d.long(), st.lengths.long()


@register_kernel('warpctc')
def _warpctc(ctx):
    """CTC negative log-likelihood a sequence -> Loss [B, 1]. Logits:
    SequenceTensor [B, T, C] before the softmax (warpctc_op applies it);
    Label: SequenceTensor [B, L(, 1)]. With ``norm_by_times`` the loss
    is divided by the sequence's length, as in the JAX kernel."""
    logits, label = _seq(ctx, 'Logits'), _seq(ctx, 'Label')
    blank = int(ctx.attr('blank', 0))
    x = logits.data
    B, T, C = x.shape
    in_lens = logits.lengths.long()
    lab, lab_lens = _ids(label)
    L = lab.shape[1]
    S = 2 * L + 1                                # blank, l1, blank, ...
    dev = x.device
    logp = torch.log_softmax(x.float(), -1)
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lab
    pos_valid = torch.arange(S, device=dev)[None, :] < \
        (2 * lab_lens + 1)[:, None]
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long,
                                   device=dev), ext[:, :-2]], 1)
    can_skip = (ext != blank) & (ext != ext_m2)
    emit = torch.gather(logp, 2, ext[:, None, :].expand(B, T, S))
    neg = torch.full((B, S), _NEG, device=dev)
    alpha = torch.cat([emit[:, 0, :1], torch.where(
        (lab_lens > 0)[:, None], emit[:, 0, 1:2], neg[:, :1]), neg[:, 2:]], 1)
    pad1 = torch.full((B, 1), _NEG, device=dev)
    pad2 = torch.full((B, 2), _NEG, device=dev)
    for t in range(1, T):
        prev1 = torch.cat([pad1, alpha[:, :-1]], 1)
        prev2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], 1),
                            neg)
        a = _logsumexp2(_logsumexp2(alpha, prev1), prev2) + emit[:, t]
        a = torch.where(pos_valid, a, neg)
        alpha = torch.where((t < in_lens)[:, None], a, alpha)
    fb = torch.gather(alpha, 1, (2 * lab_lens)[:, None])[:, 0]
    fl = torch.gather(alpha, 1, (2 * lab_lens - 1).clamp(min=0)[:, None])[:, 0]
    fl = torch.where(lab_lens > 0, fl, torch.full_like(fl, _NEG))
    nll = -_logsumexp2(fb, fl)
    if ctx.attr('norm_by_times', False):
        nll = nll / torch.clamp(in_lens.to(nll.dtype), min=1.0)
    ctx.set_output('Loss', nll[:, None])
    if ctx.output_names('WarpCTCGrad'):
        ctx.set_output('WarpCTCGrad', torch.zeros_like(x))


@register_kernel('ctc_align')
def _ctc_align(ctx):
    """Greedy CTC collapse: the argmax path, repeats merged, blanks
    dropped; ids left-packed in a [B, T, 1] buffer with new lengths
    (ctc_align_op.h)."""
    inp = _seq(ctx, 'Input')
    blank = int(ctx.attr('blank', 0))
    merge = bool(ctx.attr('merge_repeated', True))
    x = inp.data
    if x.dim() == 3 and x.shape[-1] > 1:          # probabilities [B, T, C]
        ids = torch.argmax(x, -1)
    else:                                         # token ids [B, T(, 1)]
        ids = x.long()
        if ids.dim() == 3:
            ids = ids[..., 0]
    B, T = ids.shape
    dev = ids.device
    valid = torch.arange(T, device=dev)[None, :] < inp.lengths.long()[:, None]
    prev = torch.cat([torch.full((B, 1), -1, dtype=ids.dtype, device=dev),
                      ids[:, :-1]], 1)
    keep = valid & (ids != blank)
    if merge:
        keep &= ids != prev
    dest = torch.cumsum(keep.long(), 1) - 1
    new_len = keep.sum(1)
    # the dropped ids go past the end, into a column cut off after
    out = torch.zeros((B, T + 1), dtype=torch.long, device=dev)
    out.scatter_(1, torch.where(keep, dest, torch.full_like(dest, T)),
                 torch.where(keep, ids, torch.zeros_like(ids)))
    ctx.set_output('Output', SequenceTensor(out[:, :T, None], new_len))


@register_kernel('edit_distance')
def _edit_distance(ctx):
    """Levenshtein distance of each (hypothesis, reference) pair -> [B,
    1] float32 (edit_distance_op.h). The JAX kernel's double scan over
    reference and hypothesis positions is one loop over the reference
    here: a row's recurrence val[i] = min(a[i], val[i-1] + 1) is
    i + min(j + 2, cummin(a[k] - k)), all in small integers, so exact."""
    h, hl = _ids(_seq(ctx, 'Hyps'))
    r, rl = _ids(_seq(ctx, 'Refs'))
    B, HT = h.shape
    RT = r.shape[1]
    dev = h.device
    i = torch.arange(HT, dtype=torch.float32, device=dev)[None, :]
    row = torch.minimum(torch.arange(HT + 1, dtype=torch.float32,
                                     device=dev)[None, :],
                        hl.float()[:, None])
    for j in range(RT):
        jn = float(j + 1)
        a = torch.minimum(row[:, 1:] + 1,
                          row[:, :-1] + (h != r[:, j:j + 1]).float())
        val = i + torch.clamp(torch.cummin(a - i, 1).values, max=jn + 1)
        new_row = torch.cat([torch.full((B, 1), jn, device=dev), val], 1)
        row = torch.where((j < rl)[:, None], new_row, row)
    dist = torch.gather(row, 1, hl[:, None])[:, 0]
    if ctx.attr('normalized', True):
        dist = dist / torch.clamp(rl.float(), min=1.0)
    ctx.set_output('Out', dist[:, None])
    ctx.set_output('SequenceNum', torch.tensor([B], dtype=torch.long,
                                               device=dev))
