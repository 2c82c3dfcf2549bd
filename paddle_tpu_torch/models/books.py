"""The Fluid books written with the port's layers.

The networks of the reference's python/paddle/fluid/tests/book scripts,
all of which the port runs whole: fit_a_line (book 01), recognize_digits
(book 02, conv and MLP), image_classification with the CIFAR-10 ResNet
(book 03), word2vec (book 04), recommender_system (book 05: user and
movie towers, cos_sim), understand_sentiment (book 06, its convolution
and stacked-LSTM nets), label_semantic_roles (book 07: eight features,
a stack of LSTMs, a linear-chain CRF, Viterbi decoding and a chunk
evaluator) and machine_translation (book 08: a DynamicRNN decoder
trained, a beam-search While decoding). The scripts' tables are
``is_sparse=True``: below the embedding threshold
(``layers.nn.set_sparse_fallback_threshold``) they train dense, as in
paddle_tpu. Each ``<book>()`` adds its network to the current program
guard at the script's widths (keyword arguments cut them for tests) and
returns a ``Book``; ``train(book)`` appends the script's optimizer (and
what the script builds after it), ``book.init(scope, place)`` sets what
the script sets after its startup run, and ``reader(book)`` is the
script's training reader on the port's datasets. Book 08's decoders,
``decode_dynamic`` (the script's While over 2-level LoD) and
``decode_static`` (the [B*K] form through ``nets.static_beam_decoder``),
and book 07's served decoding, ``srl_decode``, go into programs of
their own, each built under a fresh
``unique_name.guard()`` as the training program is, so their parameters
bear the trained ones' names.
"""
import math

import numpy as np

from .. import evaluator, layers, nets, optimizer, regularizer
from .. import dataset, io, reader as reader_m
from ..lod import SequenceTensor
from ..param_attr import ParamAttr
from ..reader import batch
from . import resnet

__all__ = ['Book', 'fit_a_line', 'recognize_digits_conv',
           'recognize_digits_mlp', 'image_classification', 'word2vec',
           'recommender_system', 'sentiment_conv', 'sentiment_lstm',
           'label_semantic_roles', 'srl_embedding', 'srl_decode',
           'machine_translation',
           'decode_dynamic', 'decode_static', 'decode_init_feed', 'train',
           'reader', 'BOOKS', 'MT']

WORD2VEC_N = 5


class Book(object):
    """One book's program parts: its feed variables in the reader's
    sample order, the prediction, the mean loss, the accuracy (None
    where the script has none), and the script's optimizer and batch.
    ``after_train(book)`` builds what the script adds after its
    ``minimize`` (book 07's decoding and evaluator); ``init_fn(scope,
    place)`` sets what it sets after its startup run."""

    def __init__(self, name, feeds, prediction, loss, accuracy, optimizer,
                 batch_size, after_train=None, init_fn=None):
        self.name = name
        self.feeds = feeds
        self.prediction = prediction
        self.loss = loss
        self.accuracy = accuracy
        self.optimizer = optimizer
        self.batch_size = batch_size
        self.after_train = after_train
        self.init_fn = init_fn

    def init(self, scope, place):
        """What the script does after its startup run (nothing for most
        books)."""
        if self.init_fn is not None:
            self.init_fn(scope, place)


def fit_a_line():
    """book/test_fit_a_line.py: fc 13 -> 1, square_error_cost, SGD(0.001)
    at batch 20 on uci_housing through reader.shuffle(buf_size=500)."""
    x = layers.data(name='x', shape=[13], dtype='float32')
    pred = layers.fc(input=x, size=1, act=None)
    y = layers.data(name='y', shape=[1], dtype='float32')
    loss = layers.mean(layers.square_error_cost(input=pred, label=y))
    return Book('fit_a_line', [x, y], pred, loss, None,
                lambda: optimizer.SGD(learning_rate=0.001), 20)


def _digits(name, img, pred):
    label = layers.data(name='label', shape=[1], dtype='int64')
    loss = layers.mean(layers.cross_entropy(input=pred, label=label))
    acc = layers.accuracy(input=pred, label=label)
    return Book(name, [img, label], pred, loss, acc,
                lambda: optimizer.Adam(learning_rate=0.001), 64)


def recognize_digits_conv(conv=(20, 50)):
    """book/test_recognize_digits.py, conv_net: two simple_img_conv_pool
    blocks (5x5, 20 then 50 filters, 2x2 max pools, a batch norm between
    them), fc 10 softmax, cross_entropy and accuracy; Adam(0.001) at
    batch 64 on mnist through reader.shuffle(buf_size=500)."""
    img = layers.data(name='img', shape=[1, 28, 28], dtype='float32')
    c = nets.simple_img_conv_pool(input=img, filter_size=5,
                                  num_filters=conv[0], pool_size=2,
                                  pool_stride=2, act='relu')
    c = layers.batch_norm(c)
    c = nets.simple_img_conv_pool(input=c, filter_size=5,
                                  num_filters=conv[1], pool_size=2,
                                  pool_stride=2, act='relu')
    return _digits('recognize_digits_conv', img,
                   layers.fc(input=c, size=10, act='softmax'))


def recognize_digits_mlp(hidden=200):
    """book/test_recognize_digits.py, mlp: fc 200 tanh twice, fc 10
    softmax; as conv_net otherwise."""
    img = layers.data(name='img', shape=[1, 28, 28], dtype='float32')
    h = layers.fc(input=img, size=hidden, act='tanh')
    h = layers.fc(input=h, size=hidden, act='tanh')
    return _digits('recognize_digits_mlp', img,
                   layers.fc(input=h, size=10, act='softmax'))


def image_classification(depth=32):
    """book/test_image_classification.py, resnet: resnet_cifar10 at
    depth 32 with a 10-way softmax, cross_entropy and accuracy;
    Adam(0.001) at batch 128 on cifar10 through
    reader.shuffle(buf_size=1280)."""
    images = layers.data(name='pixel', shape=[3, 32, 32], dtype='float32')
    pred = resnet.resnet_cifar10(images, class_dim=10, depth=depth)
    label = layers.data(name='label', shape=[1], dtype='int64')
    loss = layers.mean(layers.cross_entropy(input=pred, label=label))
    acc = layers.accuracy(input=pred, label=label)
    return Book('image_classification', [images, label], pred, loss, acc,
                lambda: optimizer.Adam(learning_rate=0.001), 128)


def word2vec(dict_size=None, embed=32, hidden=256):
    """book/test_word2vec.py with is_sparse=True: N = 5, four words
    looked up in one shared table of 32, concatenated, fc 256 sigmoid,
    fc dict softmax, cross_entropy with the fifth word; SGD(0.001) at
    batch 32 on imikolov's 5-grams."""
    if dict_size is None:
        dict_size = len(dataset.imikolov.build_dict())
    words = [layers.data(name=n, shape=[1], dtype='int64')
             for n in ('firstw', 'secondw', 'thirdw', 'forthw')]
    embeds = [layers.embedding(input=w, size=[dict_size, embed],
                               dtype='float32', is_sparse=True,
                               param_attr='shared_w') for w in words]
    h = layers.fc(input=layers.concat(input=embeds, axis=1), size=hidden,
                  act='sigmoid')
    pred = layers.fc(input=h, size=dict_size, act='softmax')
    nextw = layers.data(name='nextw', shape=[1], dtype='int64')
    loss = layers.mean(layers.cross_entropy(input=pred, label=nextw))
    return Book('word2vec', words + [nextw], pred, loss, None,
                lambda: optimizer.SGD(learning_rate=0.001), 32)


def recommender_system(emb=32, small=16, feat=200, title_filters=32):
    """book/test_recommender_system.py: the user tower (user id
    embedding 32 -> fc 32; gender, age and job embeddings 16 -> fc 16
    each; concat -> fc 200 tanh) and the movie tower (movie id embedding
    32 -> fc 32; category embedding 32 summed over the sequence; title
    embedding 32 -> sequence_conv_pool of 32 filters, window 3, tanh,
    sum; concat -> fc 200 tanh), cos_sim scaled by 5 against the
    rating, square_error_cost and mean; SGD(0.2) at batch 256 on
    movielens. Every table is_sparse=True."""
    ML = dataset.movielens

    def tower_input(name, vocab, dim, table=None, lod_level=0):
        x = layers.data(name=name, shape=[1], dtype='int64',
                        lod_level=lod_level)
        return x, layers.embedding(input=x, dtype='float32',
                                   size=[vocab, dim], param_attr=table,
                                   is_sparse=True)

    uid, usr_emb = tower_input('user_id', ML.max_user_id() + 1, emb,
                               'user_table')
    usr_fc = layers.fc(input=usr_emb, size=emb)
    gender, gender_emb = tower_input('gender_id', 2, small, 'gender_table')
    gender_fc = layers.fc(input=gender_emb, size=small)
    age, age_emb = tower_input('age_id', len(ML.age_table), small,
                               'age_table')
    age_fc = layers.fc(input=age_emb, size=small)
    job, job_emb = tower_input('job_id', ML.max_job_id() + 1, small,
                               'job_table')
    job_fc = layers.fc(input=job_emb, size=small)
    usr = layers.fc(input=layers.concat(
        input=[usr_fc, gender_fc, age_fc, job_fc], axis=1), size=feat,
        act='tanh')

    mov, mov_emb = tower_input('movie_id', ML.max_movie_id() + 1, emb,
                               'movie_table')
    mov_fc = layers.fc(input=mov_emb, size=emb)
    cat, cat_emb = tower_input('category_id', len(ML.movie_categories()),
                               emb, lod_level=1)
    cat_pool = layers.sequence_pool(input=cat_emb, pool_type='sum')
    title, title_emb = tower_input(
        'movie_title', len(ML.get_movie_title_dict()), emb, lod_level=1)
    title_conv = nets.sequence_conv_pool(
        input=title_emb, num_filters=title_filters, filter_size=3,
        act='tanh', pool_type='sum')
    mov_feat = layers.fc(input=layers.concat(
        input=[mov_fc, cat_pool, title_conv], axis=1), size=feat,
        act='tanh')

    pred = layers.scale(x=layers.cos_sim(X=usr, Y=mov_feat), scale=5.0)
    score = layers.data(name='score', shape=[1], dtype='float32')
    loss = layers.mean(layers.square_error_cost(input=pred, label=score))
    return Book('recommender_system',
                [uid, gender, age, job, mov, cat, title, score], pred, loss,
                None, lambda: optimizer.SGD(learning_rate=0.2), 256)


def _sentiment(name, net, dict_dim):
    """book/test_understand_sentiment.py's train(): int64 words (lod 1)
    and label, the net, cross_entropy, mean and accuracy; Adagrad(0.002)
    at batch 128 on imdb.train(word_dict) through
    reader.shuffle(buf_size=1000)."""
    if dict_dim is None:
        dict_dim = len(dataset.imdb.word_dict())
    data = layers.data(name='words', shape=[1], dtype='int64', lod_level=1)
    label = layers.data(name='label', shape=[1], dtype='int64')
    pred = net(data, dict_dim)
    loss = layers.mean(layers.cross_entropy(input=pred, label=label))
    acc = layers.accuracy(input=pred, label=label)
    return Book(name, [data, label], pred, loss, acc,
                lambda: optimizer.Adagrad(learning_rate=0.002), 128)


def sentiment_conv(dict_dim=None, emb_dim=32, hid_dim=32):
    """book 06's convolution_net: embedding 32, two sequence_conv_pool
    of 32 filters (windows 3 and 4, tanh, sqrt pooling), fc 2 softmax;
    the table is_sparse=True, as the script's."""
    def net(data, dict_dim):
        emb = layers.embedding(input=data, size=[dict_dim, emb_dim],
                               is_sparse=True)
        conv_3 = nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                         filter_size=3, act='tanh',
                                         pool_type='sqrt')
        conv_4 = nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                         filter_size=4, act='tanh',
                                         pool_type='sqrt')
        return layers.fc(input=[conv_3, conv_4], size=2, act='softmax')
    return _sentiment('sentiment_conv', net, dict_dim)


def sentiment_lstm(dict_dim=None, emb_dim=128, hid_dim=512, stacked_num=3):
    """book 06's stacked_lstm_net: embedding 128, fc 512, then 3
    dynamic_lstm of size 512 (hidden 128, the script's peepholes, every
    second one reversed), each fed an fc of the previous fc and LSTM;
    max pools of the last fc and LSTM, fc 2 softmax. Its peephole LSTMs
    run the plain scan, no hand-written kernel. The table is_sparse=True,
    as sentiment_conv's."""
    if stacked_num % 2 != 1:
        raise ValueError("stacked_num must be odd")

    def net(data, dict_dim):
        emb = layers.embedding(input=data, size=[dict_dim, emb_dim],
                               is_sparse=True)
        fc1 = layers.fc(input=emb, size=hid_dim)
        lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid_dim)
        inputs = [fc1, lstm1]
        for i in range(2, stacked_num + 1):
            fc = layers.fc(input=inputs, size=hid_dim)
            lstm, _ = layers.dynamic_lstm(input=fc, size=hid_dim,
                                          is_reverse=(i % 2) == 0)
            inputs = [fc, lstm]
        fc_last = layers.sequence_pool(input=inputs[0], pool_type='max')
        lstm_last = layers.sequence_pool(input=inputs[1], pool_type='max')
        return layers.fc(input=[fc_last, lstm_last], size=2, act='softmax')
    return _sentiment('sentiment_lstm', net, dict_dim)


# book/test_label_semantic_roles.py's word feeds, in the reader's order
SRL_WORDS = ('word_data', 'ctx_n2_data', 'ctx_n1_data', 'ctx_0_data',
             'ctx_p1_data', 'ctx_p2_data')


def srl_embedding(word_dim=32):
    """The pretrained word table the script loads after its startup:
    conll05.get_embedding()'s file, its 16-byte header skipped, f32 rows
    of ``word_dim``."""
    n = len(dataset.conll05.get_dict()[0])
    with open(dataset.conll05.get_embedding(), 'rb') as f:
        f.read(16)
        return np.fromfile(f, dtype=np.float32).reshape(n, word_dim)


def _srl_net(word_dim, mark_dim, hidden_dim, depth):
    """db_lstm: (the eight feeds in the reader's order, the emissions,
    the label count)."""
    word_dict, verb_dict, label_dict = dataset.conll05.get_dict()
    words = [layers.data(name=n, shape=[1], dtype='int64', lod_level=1)
             for n in SRL_WORDS[:1]]
    predicate = layers.data(name='verb_data', shape=[1], dtype='int64',
                            lod_level=1)
    words += [layers.data(name=n, shape=[1], dtype='int64', lod_level=1)
              for n in SRL_WORDS[1:]]
    mark = layers.data(name='mark_data', shape=[1], dtype='int64',
                       lod_level=1)
    pred_emb = layers.embedding(input=predicate, dtype='float32',
                                size=[len(verb_dict), word_dim],
                                is_sparse=True, param_attr='vemb')
    mark_emb = layers.embedding(input=mark, dtype='float32',
                                size=[2, mark_dim], is_sparse=True)
    embs = [layers.embedding(input=x, size=[len(word_dict), word_dim],
                             param_attr=ParamAttr(name='emb',
                                                  trainable=False))
            for x in words] + [pred_emb, mark_emb]
    hidden_0 = layers.sums(input=[
        layers.fc(input=e, size=hidden_dim, act='tanh') for e in embs])
    lstm_0, _ = layers.dynamic_lstm(
        input=hidden_0, size=hidden_dim, candidate_activation='relu',
        gate_activation='sigmoid', cell_activation='sigmoid')
    inputs = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = layers.sums(input=[
            layers.fc(input=inputs[0], size=hidden_dim, act='tanh'),
            layers.fc(input=inputs[1], size=hidden_dim, act='tanh')])
        lstm, _ = layers.dynamic_lstm(
            input=mix_hidden, size=hidden_dim, candidate_activation='relu',
            gate_activation='sigmoid', cell_activation='sigmoid',
            is_reverse=(i % 2) == 1)
        inputs = [mix_hidden, lstm]
    feature_out = layers.sums(input=[
        layers.fc(input=inputs[0], size=len(label_dict), act='tanh'),
        layers.fc(input=inputs[1], size=len(label_dict), act='tanh')])
    return words + [predicate, mark], feature_out, len(label_dict)


def label_semantic_roles(word_dim=32, mark_dim=5, hidden_dim=512, depth=8):
    """book/test_label_semantic_roles.py: eight features (the word, five
    context words and the predicate, each embedded 32 wide, and the mark
    embedded 5 wide; the six word lookups share the table 'emb', loaded
    from conll05.get_embedding() after the startup and not trainable)
    each through fc 512 tanh, summed; ``depth`` dynamic_lstms of size
    512 (candidate relu, gate and cell sigmoid, the script's peepholes,
    every second one reversed), each fed the sum of an fc of the
    previous sum and one of the previous LSTM; the emissions are the sum
    of two fc of the label count, tanh. linear_chain_crf with its
    transitions 'crfw' at learning rate 1e-3, the mean cost,
    SGD(exponential_decay(0.01, 100000, 0.5, staircase=True)) at batch
    10 on conll05.test() through reader.shuffle(buf_size=8192). After
    the optimizer, as in the script: crf_decoding under 'crfw'
    (``book.decode``) and ChunkEvaluator(chunk_scheme='IOB')
    (``book.evaluator``). The predicate and mark tables are
    is_sparse=True, as the script's. Its LSTMs have peepholes and
    non-default activations: they run the plain scan, and this book runs
    no hand-written kernel."""
    feeds, feature_out, n_labels = _srl_net(word_dim, mark_dim, hidden_dim,
                                            depth)
    target = layers.data(name='target', shape=[1], dtype='int64',
                         lod_level=1)
    crf_cost = layers.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=ParamAttr(name='crfw', learning_rate=1e-3))
    loss = layers.mean(crf_cost)

    def after_train(book):
        book.decode = layers.crf_decoding(input=feature_out,
                                          param_attr=ParamAttr(name='crfw'))
        book.evaluator = evaluator.ChunkEvaluator(
            input=book.decode, label=target, chunk_scheme='IOB',
            num_chunk_types=int(math.ceil((n_labels - 1) / 2.0)))

    def init_fn(scope, place):
        io.params_from_numpy(scope, {'emb': srl_embedding(word_dim)}, place)

    return Book('label_semantic_roles', feeds + [target], feature_out, loss,
                None,
                lambda: optimizer.SGD(learning_rate=layers.exponential_decay(
                    learning_rate=0.01, decay_steps=100000, decay_rate=0.5,
                    staircase=True)), 10, after_train=after_train,
                init_fn=init_fn)


def srl_decode(word_dim=32, mark_dim=5, hidden_dim=512, depth=8):
    """Book 07's inference program: the same network and crf_decoding
    under the transitions 'crfw' (made here by name, the training
    program's shape). Built under a fresh ``unique_name.guard()``, as the
    training program is, its parameters bear the trained ones' names, so
    it saves and serves the decoding without the training program's
    update ops (a prune of the training program to ``book.decode`` keeps
    'crfw''s SGD op, which writes it). Returns (feeds, decode)."""
    feeds, feature_out, n_labels = _srl_net(word_dim, mark_dim, hidden_dim,
                                            depth)
    layers.create_parameter(shape=[n_labels + 2, n_labels], dtype='float32',
                            name='crfw')
    return feeds, layers.crf_decoding(input=feature_out,
                                      param_attr=ParamAttr(name='crfw'))


# book/test_machine_translation.py's widths
MT = dict(dict_size=30000, word_dim=16, hidden_dim=32, batch_size=2,
          max_length=8, topk_size=50, beam_size=2, end_id=10)


def _mt_encoder(dict_size, word_dim, hidden_dim):
    """embedding (the shared table 'vemb'), fc 4 * hidden tanh,
    dynamic_lstm of 4 * hidden (the default peepholes), last step."""
    src = layers.data(name='src_word_id', shape=[1], dtype='int64',
                      lod_level=1)
    emb = layers.embedding(input=src, size=[dict_size, word_dim],
                           dtype='float32', is_sparse=True,
                           param_attr=ParamAttr(name='vemb'))
    fc1 = layers.fc(input=emb, size=hidden_dim * 4, act='tanh')
    lstm_hidden0, _ = layers.dynamic_lstm(input=fc1, size=hidden_dim * 4)
    return src, layers.sequence_last_step(input=lstm_hidden0)


def machine_translation(dict_size=None, word_dim=None, hidden_dim=None):
    """book/test_machine_translation.py, train: the encoder, then a
    DynamicRNN whose memory starts from the encoder's state; a step runs
    fc([word, state], hidden, tanh) and fc(dict, softmax); cross_entropy
    and mean; Adagrad(1e-4) with L2Decay(0.1) at batch 2 on wmt14.

    The words are looked up is_sparse=True, as in the script."""
    dict_size = dict_size or MT['dict_size']
    word_dim = word_dim or MT['word_dim']
    hidden_dim = hidden_dim or MT['hidden_dim']
    src, context = _mt_encoder(dict_size, word_dim, hidden_dim)
    trg = layers.data(name='target_language_word', shape=[1],
                      dtype='int64', lod_level=1)
    trg_emb = layers.embedding(input=trg, size=[dict_size, word_dim],
                               dtype='float32', is_sparse=True,
                               param_attr=ParamAttr(name='vemb'))
    rnn = layers.DynamicRNN()
    with rnn.block():
        current_word = rnn.step_input(trg_emb)
        pre_state = rnn.memory(init=context)
        current_state = layers.fc(input=[current_word, pre_state],
                                  size=hidden_dim, act='tanh')
        current_score = layers.fc(input=current_state, size=dict_size,
                                  act='softmax')
        rnn.update_memory(pre_state, current_state)
        rnn.output(current_score)
    pred = rnn()
    label = layers.data(name='target_language_next_word', shape=[1],
                        dtype='int64', lod_level=1)
    loss = layers.mean(layers.cross_entropy(input=pred, label=label))
    return Book('machine_translation', [src, trg, label], pred, loss, None,
                lambda: optimizer.Adagrad(
                    learning_rate=1e-4,
                    regularization=regularizer.L2DecayRegularizer(
                        regularization_coeff=0.1)), MT['batch_size'])


def _mt_step(pre_ids, pre_state, dict_size, word_dim, hidden_dim):
    """One decoder step on dense rows: the trained fc_1 (word, state)
    and fc_2."""
    emb = layers.embedding(input=pre_ids, size=[dict_size, word_dim],
                           dtype='float32', param_attr=ParamAttr(
                               name='vemb'))
    state = layers.fc(input=[emb, pre_state], size=hidden_dim, act='tanh')
    return layers.fc(input=state, size=dict_size, act='softmax'), state


def decode_dynamic(dict_size=None, word_dim=None, hidden_dim=None,
                   beam_size=None, max_length=None, topk_size=None,
                   end_id=None):
    """book/test_machine_translation.py, decode: a While over the
    2-level LoD ``init_ids`` / ``init_scores`` (fed packed, as
    ``decode_init_feed`` makes them); its body reads the arrays,
    sequence_expands the state to the beams, embeds, runs the decoder's
    fc, lod_resets it to the scores' LoD, softmax fc, topk, beam_search,
    increment and array_write; beam_search_decode after the loop.
    Returns (feeds, translation_ids, translation_scores).

    Two departures from the script, so the decoder runs the trained
    parameters: its embedding is the shared table 'vemb' (the script's
    has no name), and the fc takes [word, state], the training step's
    order (the script's decode has [state, word])."""
    dict_size = dict_size or MT['dict_size']
    word_dim = word_dim or MT['word_dim']
    hidden_dim = hidden_dim or MT['hidden_dim']
    beam_size = beam_size or MT['beam_size']
    max_length = max_length or MT['max_length']
    topk_size = topk_size or MT['topk_size']
    end_id = MT['end_id'] if end_id is None else end_id
    src, init_state = _mt_encoder(dict_size, word_dim, hidden_dim)
    array_len = layers.fill_constant(shape=[1], dtype='int64',
                                     value=max_length)
    counter = layers.zeros(shape=[1], dtype='int64', force_cpu=True)
    state_array = layers.create_array('float32')
    layers.array_write(init_state, array=state_array, i=counter)
    ids_array = layers.create_array('int64')
    scores_array = layers.create_array('float32')
    init_ids = layers.data(name='init_ids', shape=[1], dtype='int64',
                           lod_level=2)
    init_scores = layers.data(name='init_scores', shape=[1],
                              dtype='float32', lod_level=2)
    layers.array_write(init_ids, array=ids_array, i=counter)
    layers.array_write(init_scores, array=scores_array, i=counter)
    cond = layers.less_than(x=counter, y=array_len)
    while_op = layers.While(cond=cond)
    with while_op.block():
        pre_ids = layers.array_read(array=ids_array, i=counter)
        pre_state = layers.array_read(array=state_array, i=counter)
        pre_score = layers.array_read(array=scores_array, i=counter)
        pre_state_expanded = layers.sequence_expand(pre_state, pre_score)
        pre_ids_emb = layers.embedding(
            input=pre_ids, size=[dict_size, word_dim], dtype='float32',
            param_attr=ParamAttr(name='vemb'))
        current_state = layers.fc(input=[pre_ids_emb, pre_state_expanded],
                                  size=hidden_dim, act='tanh')
        current_state_with_lod = layers.lod_reset(x=current_state,
                                                  y=pre_score)
        current_score = layers.fc(input=current_state_with_lod,
                                  size=dict_size, act='softmax')
        topk_scores, topk_indices = layers.topk(current_score, k=topk_size)
        selected_ids, selected_scores = layers.beam_search(
            pre_ids, topk_indices, topk_scores, beam_size, end_id=end_id,
            level=0)
        layers.increment(x=counter, value=1, in_place=True)
        layers.array_write(current_state, array=state_array, i=counter)
        layers.array_write(selected_ids, array=ids_array, i=counter)
        layers.array_write(selected_scores, array=scores_array, i=counter)
        layers.less_than(x=counter, y=array_len, cond=cond)
    ids, scores = layers.beam_search_decode(ids=ids_array,
                                            scores=scores_array)
    return [src, init_ids, init_scores], ids, scores


def decode_init_feed(batch_size, start_id=0):
    """``init_ids`` (the start id) and ``init_scores`` (1.0) for a batch,
    as the script feeds them: ``LoDTensor()``, ``set(rows)`` and
    ``set_lod([[0, 1, .., B], [0, 1, .., B]])``, so they stay packed."""
    lod = [list(range(batch_size + 1))] * 2
    feed = {}
    for name, rows in (('init_ids', np.full((batch_size, 1), start_id,
                                            'int64')),
                       ('init_scores', np.ones((batch_size, 1),
                                               'float32'))):
        t = SequenceTensor()
        t.set(rows)
        t.set_lod(lod)
        feed[name] = t
    return feed


def decode_static(dict_size=None, word_dim=None, hidden_dim=None,
                  beam_size=None, max_length=None, topk_size=None,
                  end_id=None, start_id=0):
    """The [B*K] form of the decode (tests/test_books.py's book 08):
    the encoder's state tiled to the beams, then
    ``nets.static_beam_decoder`` over the same step as decode_dynamic's.
    Returns (feeds, ids, scores)."""
    dict_size = dict_size or MT['dict_size']
    word_dim = word_dim or MT['word_dim']
    hidden_dim = hidden_dim or MT['hidden_dim']
    beam_size = beam_size or MT['beam_size']
    src, enc = _mt_encoder(dict_size, word_dim, hidden_dim)
    enc_beam = layers.reshape(layers.expand(
        layers.unsqueeze(enc, axes=[1]), expand_times=[1, beam_size, 1]),
        shape=[-1, hidden_dim])
    ids, scores = nets.static_beam_decoder(
        lambda pre_ids, pre_state: _mt_step(pre_ids, pre_state, dict_size,
                                            word_dim, hidden_dim),
        enc_beam, beam_size=beam_size,
        max_len=max_length or MT['max_length'],
        end_id=MT['end_id'] if end_id is None else end_id,
        init_id=start_id, topk_size=topk_size or MT['topk_size'])
    return [src], ids, scores


def train(book):
    """Append the script's optimizer, then what the script builds after
    it."""
    opt = book.optimizer()
    opt.minimize(book.loss)
    if book.after_train is not None:
        book.after_train(book)
    return opt


def reader(book, batch_size=None):
    """The script's training reader: batches of ``batch_size`` (the
    script's by default) from the book's dataset."""
    bs = batch_size or book.batch_size
    if book.name == 'fit_a_line':
        return batch(reader_m.shuffle(dataset.uci_housing.train(),
                                      buf_size=500), bs)
    if book.name.startswith('recognize_digits'):
        return batch(reader_m.shuffle(dataset.mnist.train(), buf_size=500),
                     bs)
    if book.name == 'image_classification':
        return batch(reader_m.shuffle(dataset.cifar.train10(),
                                      buf_size=128 * 10), bs)
    if book.name.startswith('sentiment'):
        return batch(reader_m.shuffle(
            dataset.imdb.train(dataset.imdb.word_dict()), buf_size=1000), bs)
    if book.name == 'machine_translation':
        return batch(dataset.wmt14.train(book.prediction.shape[-1]), bs)
    if book.name == 'recommender_system':
        return batch(reader_m.shuffle(dataset.movielens.train(),
                                      buf_size=8192), bs)
    if book.name == 'label_semantic_roles':
        return batch(reader_m.shuffle(dataset.conll05.test(),
                                      buf_size=8192), bs)
    word_dict = dataset.imikolov.build_dict()
    return batch(dataset.imikolov.train(word_dict, WORD2VEC_N), bs)


BOOKS = {'fit_a_line': fit_a_line,
         'recognize_digits_conv': recognize_digits_conv,
         'recognize_digits_mlp': recognize_digits_mlp,
         'image_classification': image_classification,
         'word2vec': word2vec,
         'recommender_system': recommender_system,
         'sentiment_conv': sentiment_conv,
         'sentiment_lstm': sentiment_lstm,
         'label_semantic_roles': label_semantic_roles,
         'machine_translation': machine_translation}
