"""Beam search ops, in the static [B*K] form and the dynamic LoD form.

Counterpart of paddle_tpu/ops/search_ops.py (parity:
paddle/fluid/operators/{beam_search_op,beam_search_decode_op}.cc).

The static form keeps a fixed beam width K on dense rows: row r is
batch r // K, beam slot r % K. A finished beam (pre_id == end_id) emits
end_id with its score frozen, so every shape is fixed. The top K of
each batch's K * C candidates are taken by a stable descending sort, so
among equal scores the lower index comes first, as ``lax.top_k`` orders
them (``torch.topk`` promises no order on the card). ``parent_idx`` is a
global row index, batch offset included.

The dynamic form is the reference's: 2-level LoD candidates in packed
rows, the top K of each source across its live beams, finished beams
pruned so the row count shrinks. It runs in a dynamic program (a While
fed 2-level LoD, ``executor._is_dynamic_program``): the candidates are
read on the host once a step (``host_read``), the LoD bookkeeping is
host lists, and the selected rows go back to the device packed.
"""
import numpy as np
import torch

from ..core.registry import register_kernel
from ..lod import SequenceTensor
from .common import host_read, unwrap

_NEG = -1e9


def _packed(rows, lod, dtype, device):
    return SequenceTensor.from_packed(
        torch.tensor(np.asarray(rows), dtype=dtype, device=device), lod)


def _beam_search_dynamic(ctx, pre):
    """operators/beam_search_op.cc on host lists."""
    ids, scores, pre_data = host_read(
        unwrap(ctx.input('ids')), unwrap(ctx.input('scores')), pre.data)
    ids = ids.reshape(ids.shape[0], -1)
    scores = scores.astype(np.float32).reshape(scores.shape[0], -1)
    K = int(ctx.attr('beam_size'))
    end_id = int(ctx.attr('end_id'))
    level = int(ctx.attr('level', 0))
    offs = pre.offsets()
    # ToAbsOffset (beam_search_op.cc:30): level-0 entries index the next
    # level's entries, not rows; compose down to absolute row offsets so
    # every live beam row of a source is scanned
    high = [int(o) for o in offs[level]]
    for lv in range(level + 1, len(offs)):
        high = [int(offs[lv][i]) for i in high]
    N, C = ids.shape
    pre_data = pre_data.reshape(-1)

    buckets = [[] for _ in range(N)]   # per parent row, selected items
    for s in range(len(high) - 1):
        items = [(r, int(ids[r, d]), float(scores[r, d]))
                 for r in range(high[s], high[s + 1]) for d in range(C)]
        items.sort(key=lambda it: -it[2])
        for it in items[:K]:
            buckets[it[0]].append(it)
    for r in range(N):                 # PruneEndidCandidates
        if int(pre_data[r]) == end_id:
            buckets[r] = []

    out_ids, out_scores, parents, low = [], [], [], [0]
    for r in range(N):
        # beam_search_op.cc:64-69 re-sorts each parent bucket by
        # (offset, id); within a bucket the offsets are equal
        for it in sorted(buckets[r], key=lambda it: (it[0], it[1])):
            out_ids.append(it[1])
            out_scores.append(it[2])
            parents.append(r)
        low.append(len(out_ids))
    # lod[0] is the absolute high level (the parent-row offsets, the
    # index space of lod[1]'s buckets), as in the reference
    lod = [high, low]
    dev = ctx.device
    ctx.set_output('selected_ids', _packed(
        np.reshape(out_ids, (-1, 1)), lod, torch.int64, dev))
    ctx.set_output('selected_scores', _packed(
        np.reshape(out_scores, (-1, 1)), lod, torch.float32, dev))
    if ctx.output_names('parent_idx'):
        ctx.set_output('parent_idx', _packed(
            np.reshape(parents, (-1, 1)), lod, torch.int32, dev))


@register_kernel('beam_search')
def _beam_search(ctx):
    pre = ctx.input('pre_ids')
    if isinstance(pre, SequenceTensor) and pre.packed_mode and \
            len(pre.offsets()) >= 2:
        _beam_search_dynamic(ctx, pre)
        return
    pre_ids = unwrap(pre).reshape(-1)                          # [B*K]
    ids = unwrap(ctx.input('ids'))                             # [B*K, C]
    scores = unwrap(ctx.input('scores'))                       # [B*K, C]
    if ids.dim() == 3:
        ids = ids[..., 0]
    if scores.dim() == 3:
        scores = scores[..., 0]
    K = int(ctx.attr('beam_size'))
    end_id = int(ctx.attr('end_id'))
    BK, C = ids.shape
    B = BK // K

    finished = (pre_ids == end_id)[:, None]
    # a finished beam offers one candidate: (end_id, its accumulated
    # score, which it carries in scores[:, 0])
    ids = torch.where(finished, torch.full_like(ids, end_id), ids)
    first = torch.arange(C, device=ids.device)[None, :] == 0
    frozen = torch.where(first, scores[:, :1], torch.full_like(scores, _NEG))
    scores = torch.where(finished, frozen, scores)

    top_scores, flat_idx = torch.sort(scores.reshape(B, K * C), dim=1,
                                      descending=True, stable=True)
    top_scores, flat_idx = top_scores[:, :K], flat_idx[:, :K]
    parent = flat_idx // C + (torch.arange(B, device=ids.device) * K)[:, None]
    tok = torch.gather(ids.reshape(B, K * C), 1, flat_idx)
    ctx.set_output('selected_ids', tok.reshape(BK, 1))
    ctx.set_output('selected_scores', top_scores.reshape(BK, 1))
    if ctx.output_names('parent_idx'):
        ctx.set_output('parent_idx', parent.reshape(BK, 1).to(torch.int32))


def _beam_search_decode_dynamic(ctx, ids_list, scores_list):
    """PackAllSteps (operators/beam_search_decode_op.h) on host lists:
    walk the per-step LoD trees, closing a sentence where a prefix has
    no children, and emit every sentence of each source under a fresh
    2-level LoD."""
    host = host_read(*[unwrap(e) for e in ids_list],
                     *[unwrap(e) for e in scores_list])
    n = len(ids_list)
    steps = [(host[k].reshape(-1), host[n + k].astype(np.float32)
              .reshape(-1), ids_list[k].offsets()) for k in range(n)]
    src_num = len(steps[0][2][0]) - 1

    def make_sentence(node):
        words, scs = [], []
        while node is not None:
            words.append(node[0])
            scs.append(node[1])
            node = node[2]
        return words[::-1], scs[::-1]

    prefixes = []                      # per source: its leaf nodes
    sentences = [[] for _ in range(src_num)]
    for ivals, svals, offs in steps:   # PackTwoSteps per step
        high, low = offs[0], offs[1] if len(offs) > 1 else None
        new_prefixes = []
        for s in range(src_num):
            src_start, src_end = int(high[s]), int(high[s + 1])
            nodes = []
            if not prefixes:           # the first step: roots
                for r in range(src_start, src_end):
                    nodes.append((int(ivals[r]), float(svals[r]), None))
            else:
                for pi, prefix in enumerate(prefixes[s]):
                    c0 = int(low[src_start + pi])
                    c1 = int(low[src_start + pi + 1])
                    if c0 == c1:       # finished: collect the sentence
                        sentences[s].append(make_sentence(prefix))
                    else:
                        for r in range(c0, c1):
                            nodes.append((int(ivals[r]), float(svals[r]),
                                          prefix))
            new_prefixes.append(nodes)
        prefixes = new_prefixes
    for s in range(src_num):           # the surviving prefixes
        for node in prefixes[s]:
            sentences[s].append(make_sentence(node))

    src_lod, sent_lod = [0], [0]
    id_data, sc_data = [], []
    for s in range(src_num):
        for words, scs in sentences[s]:
            id_data.extend(words)
            sc_data.extend(scs)
            sent_lod.append(sent_lod[-1] + len(words))
        src_lod.append(src_lod[-1] + len(sentences[s]))
    lod = [src_lod, sent_lod]
    ctx.set_output('SentenceIds', _packed(id_data, lod, torch.int64,
                                          ctx.device))
    ctx.set_output('SentenceScores', _packed(sc_data, lod, torch.float32,
                                             ctx.device))


@register_kernel('beam_search_decode')
def _beam_search_decode(ctx):
    """Backtrack the tensor arrays of (ids, scores, parents) written once
    a decode step. SentenceIds: SequenceTensor [B*K, n], where n is the
    number of steps written: row r holds the whole path of (batch r // K,
    slot r % K); SentenceScores holds each beam's final score at every
    position."""
    ids_arr = ctx.input('Ids')
    scores_arr = ctx.input('Scores')
    parents_arr = ctx.input('Parents')
    ids_list = [e for e in ids_arr['list'] if e is not None]
    sc_list = [e for e in scores_arr['list'] if e is not None]
    if isinstance(ids_list[0], SequenceTensor) and ids_list[0].packed_mode:
        _beam_search_decode_dynamic(ctx, ids_list, sc_list)
        return
    if parents_arr is None:
        raise ValueError("beam_search_decode needs the Parents array "
                         "(pass parent_idx from layers.beam_search)")

    def steps(arr):
        lst = arr['list']
        proto = unwrap(next(e for e in lst if e is not None))
        buf = torch.stack([torch.zeros_like(proto) if e is None
                           else unwrap(e) for e in lst])
        return buf[..., 0] if buf.dim() == 3 else buf        # [n, BK]

    ids_buf, par_buf, sc_buf = steps(ids_arr), steps(parents_arr), \
        steps(scores_arr)
    n, BK = ids_buf.shape
    # walk back from the last step: each slot follows its parent chain
    slot = torch.arange(BK, device=ids_buf.device)
    toks = []
    for t in range(n - 1, -1, -1):
        toks.append(ids_buf[t].gather(0, slot))
        slot = par_buf[t].gather(0, slot).long()
    toks = torch.stack(toks[::-1], 1)                          # [BK, n]
    lengths = torch.full((BK,), n, dtype=torch.int64, device=toks.device)
    final = sc_buf[n - 1]
    ctx.set_output('SentenceIds', SequenceTensor(toks, lengths))
    ctx.set_output('SentenceScores', SequenceTensor(
        final[:, None].expand(BK, n).contiguous(), lengths))
