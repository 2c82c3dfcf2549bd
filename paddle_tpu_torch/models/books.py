"""The Fluid books written with the port's layers.

The networks of the reference's python/paddle/fluid/tests/book scripts
that the port runs whole: fit_a_line (book 01), recognize_digits (book
02, conv and MLP), image_classification with the CIFAR-10 ResNet (book
03) and word2vec (book 04, dense embedding). Each ``<book>()`` adds its
network to the current program guard at the script's widths (keyword
arguments cut them for tests) and returns a ``Book``; ``train(book)``
appends the script's optimizer, and ``reader(book)`` is the script's
training reader on the port's datasets.
"""
from .. import layers, nets, optimizer
from .. import dataset, reader as reader_m
from ..reader import batch
from . import resnet

__all__ = ['Book', 'fit_a_line', 'recognize_digits_conv',
           'recognize_digits_mlp', 'image_classification', 'word2vec',
           'train', 'reader', 'BOOKS']

WORD2VEC_N = 5


class Book(object):
    """One book's program parts: its feed variables in the reader's
    sample order, the prediction, the mean loss, the accuracy (None
    where the script has none), and the script's optimizer and batch."""

    def __init__(self, name, feeds, prediction, loss, accuracy, optimizer,
                 batch_size):
        self.name = name
        self.feeds = feeds
        self.prediction = prediction
        self.loss = loss
        self.accuracy = accuracy
        self.optimizer = optimizer
        self.batch_size = batch_size


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
    """book/test_word2vec.py with is_sparse=False: N = 5, four words
    looked up in one shared table of 32, concatenated, fc 256 sigmoid,
    fc dict softmax, cross_entropy with the fifth word; SGD(0.001) at
    batch 32 on imikolov's 5-grams."""
    if dict_size is None:
        dict_size = len(dataset.imikolov.build_dict())
    words = [layers.data(name=n, shape=[1], dtype='int64')
             for n in ('firstw', 'secondw', 'thirdw', 'forthw')]
    embeds = [layers.embedding(input=w, size=[dict_size, embed],
                               dtype='float32', is_sparse=False,
                               param_attr='shared_w') for w in words]
    h = layers.fc(input=layers.concat(input=embeds, axis=1), size=hidden,
                  act='sigmoid')
    pred = layers.fc(input=h, size=dict_size, act='softmax')
    nextw = layers.data(name='nextw', shape=[1], dtype='int64')
    loss = layers.mean(layers.cross_entropy(input=pred, label=nextw))
    return Book('word2vec', words + [nextw], pred, loss, None,
                lambda: optimizer.SGD(learning_rate=0.001), 32)


def train(book):
    """Append the script's optimizer."""
    opt = book.optimizer()
    opt.minimize(book.loss)
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
    word_dict = dataset.imikolov.build_dict()
    return batch(dataset.imikolov.train(word_dict, WORD2VEC_N), bs)


BOOKS = {'fit_a_line': fit_a_line,
         'recognize_digits_conv': recognize_digits_conv,
         'recognize_digits_mlp': recognize_digits_mlp,
         'image_classification': image_classification,
         'word2vec': word2vec}
