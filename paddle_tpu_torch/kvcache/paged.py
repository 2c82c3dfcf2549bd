"""Paged attention cell: the slotted ``attention_history_cell`` with its
per-slot dense KV replaced by :class:`~paddle_tpu_torch.kvcache.pool.
PagePool` pages: bit-identical outputs at the same slot count, pooled
memory.

Counterpart of paddle_tpu/kvcache/paged.py, built from the same layers.

Layout. The slotted cell carries ``kv [max_len, word_dim]`` PER SLOT;
here the same rows live scattered across a shared pool tensor
``[num_pages, page_size, word_dim]`` and each slot's
:class:`~paddle_tpu_torch.kvcache.pool.BlockTable` names which pages
hold its positions. The step program takes three extra per-slot feeds
the engine derives on the host from each slot's position and table:
``kv_table [max_pages] int64`` (the padded page list), ``kv_page [1]
int64`` (the pool page this step's write lands in) and ``kv_off [1]
int64`` (the offset inside it), plus the pool tensors themselves,
which are fed and fetched like any other decode state.

Write path (all row-wise ops, exactly like the slotted cell's one-hot
outer product): ``one_hot(kv_page) (x) one_hot(kv_off)`` selects one
``(page, offset)`` cell per slot; its transpose matmul against the
token embeddings scatters each slot's embedding into its cell, and the
result adds onto the pool. A retired slot is fed ``kv_page =
num_pages``: out of range, so its one-hot row is all zeros and it
writes nothing. The port's ``one_hot`` compares against ``arange``
(``ops/tensor_ops.py``), so an out-of-range id gives zeros on the card
too, where ``F.one_hot`` would trip a device-side assert and take the
CUDA context down with every replica in the process.

Read path: gather the slot's pages by table, reshape to the same
``[S, max_len, word_dim]`` the slotted cell attends over, and run the
IDENTICAL mask/softmax/context ops.

Bit-identity argument (``tests/test_torch_kvcache.py``): every
``(page, offset)`` cell is owned by exactly one slot at one step, so
the scatter matmul's contraction sums one embedding against zeros
(exact in IEEE arithmetic; TF32 stays off), and pages are zeroed on
alloc, so a gathered row holds precisely the embedding the slotted
cell's dense row would. Identical operand values into identical
attention ops at the same slot count give bit-identical tokens.
"""
from .. import layers

__all__ = ['paged_attention_cell']


def paged_attention_cell(dict_size, word_dim=32, hidden=32, max_len=64,
                         page_size=8, num_pages=32):
    """Build the paged analogue of :func:`~paddle_tpu_torch.fleet.decode.
    attention_history_cell`.

    Returns ``(cell_fn, state_specs, pool_specs)``:

    - ``cell_fn(pre_ids, states, pos, pools, table, page, offset) ->
      (probs, new_states, new_pools)`` — the signature
      ``DecodeEngine(admission='paged')`` drives;
    - ``state_specs`` — the per-slot state that STAYS slotted
      (``mask [max_len]``, ``h [hidden]``: tiny, so slots are cheap
      and the batch dim can grow past what dense KV allowed);
    - ``pool_specs`` — what a :class:`~paddle_tpu_torch.kvcache.pool.
      PagePool` must be built with (``[('kv', [word_dim])]``).

    The cell must agree with the pool geometry: construct the pool as
    ``PagePool(pool_specs, num_pages=num_pages, page_size=page_size)``.
    """
    if max_len % page_size != 0:
        raise ValueError('max_len (%d) must be a multiple of '
                         'page_size (%d)' % (max_len, page_size))
    max_pages = max_len // page_size

    def cell(pre_ids, states, pos, pools, table, page, offset):
        kvpool = pools['kv']                       # [NP, P, D]
        mask, h = states['mask'], states['h']
        emb = layers.embedding(input=pre_ids, size=[dict_size, word_dim])
        emb = layers.reshape(emb, shape=[-1, word_dim])       # [S, D]
        # scatter emb into pool[page, offset]: one_hot(page) (x)
        # one_hot(offset) selects one cell per slot (all-zero for a
        # retired slot fed page == num_pages), and the transposed
        # matmul against emb sums exactly one embedding into it
        page_oh = layers.one_hot(page, depth=num_pages)       # [S, NP]
        off_oh = layers.one_hot(offset, depth=page_size)      # [S, P]
        sel = layers.matmul(
            layers.reshape(page_oh, shape=[-1, num_pages, 1]),
            layers.reshape(off_oh, shape=[-1, 1, page_size]))
        sel = layers.reshape(sel, shape=[-1, num_pages * page_size])
        write = layers.matmul(sel, emb, transpose_x=True)   # [NP*P, D]
        kvpool = layers.elementwise_add(
            kvpool, layers.reshape(write,
                                   shape=[-1, page_size, word_dim]))
        # the position mask stays per-slot state, same as the slotted
        # cell: one_hot(pos) accumulates the valid-prefix indicator
        mask = layers.elementwise_add(
            mask, layers.one_hot(pos, depth=max_len))         # [S, L]
        # gather this slot's pages back into the dense [S, L, D] view
        # the slotted cell attends over (padding table entries gather a
        # live page, but the mask zeroes their weight exactly)
        flat = layers.reshape(kvpool,
                              shape=[-1, page_size * word_dim])
        kv = layers.reshape(layers.gather(flat, table),
                            shape=[-1, max_pages * page_size, word_dim])
        # identical attention ops to attention_history_cell from here
        query = layers.fc(input=layers.concat([h, emb], axis=-1),
                          size=word_dim, act='tanh')          # [S, D]
        scores = layers.reshape(
            layers.matmul(kv, layers.reshape(
                query, shape=[-1, word_dim, 1])),
            shape=[-1, max_len])                              # [S, L]
        scores = layers.elementwise_add(
            scores, layers.scale(mask, scale=1e9, bias=-1e9))
        attn = layers.softmax(scores)
        ctx = layers.reshape(
            layers.matmul(layers.reshape(attn, shape=[-1, 1, max_len]),
                          kv),
            shape=[-1, word_dim])                             # [S, D]
        h = layers.fc(input=layers.concat([h, ctx], axis=-1),
                      size=hidden, act='tanh')
        probs = layers.fc(input=h, size=dict_size, act='softmax')
        return probs, {'mask': mask, 'h': h}, {'kv': kvpool}

    return cell, [('mask', [max_len]), ('h', [hidden])], \
        [('kv', [word_dim])]
