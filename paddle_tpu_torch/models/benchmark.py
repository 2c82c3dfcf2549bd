"""The image models of the reference's benchmark harness, written with
the port's layers: ``mnist`` and ``vgg`` as benchmark/fluid/models.py
builds them (conv 20 and 50 of 5x5 taps, each with a 2x2 max pool, then
a 10-way softmax on 1x28x28; VGG-16 on 3x32x32 with 10 classes), and
``train`` as benchmark/fluid/fluid_benchmark.py trains them, with
``Momentum(0.01, 0.9)``.

Each builder adds its program to the current program guard and returns
``(avg_loss, prediction)``; the data layers are ``data`` (images) and
``label`` (int64 classes).
"""
from .. import layers, nets, optimizer
from . import vgg as vgg_m

__all__ = ['mnist', 'vgg', 'train', 'IMAGE_SHAPES']

# each model's input image (C, H, W) and its classes
IMAGE_SHAPES = {'mnist': ((1, 28, 28), 10), 'vgg': ((3, 32, 32), 10)}


def _inputs(name):
    shape, _ = IMAGE_SHAPES[name]
    img = layers.data(name='data', shape=list(shape), dtype='float32')
    label = layers.data(name='label', shape=[1], dtype='int64')
    return img, label


def mnist():
    """benchmark/fluid/models.py:24-37."""
    img, label = _inputs('mnist')
    conv1 = nets.simple_img_conv_pool(input=img, filter_size=5,
                                      num_filters=20, pool_size=2,
                                      pool_stride=2, act='relu')
    conv2 = nets.simple_img_conv_pool(input=conv1, filter_size=5,
                                      num_filters=50, pool_size=2,
                                      pool_stride=2, act='relu')
    predict = layers.fc(input=conv2, size=10, act='softmax')
    cost = layers.cross_entropy(input=predict, label=label)
    return layers.mean(x=cost), predict


def vgg():
    """benchmark/fluid/models.py:40-48."""
    img, label = _inputs('vgg')
    predict = vgg_m.vgg16(img, class_dim=IMAGE_SHAPES['vgg'][1])
    cost = layers.cross_entropy(input=predict, label=label)
    return layers.mean(x=cost), predict


def train(loss, learning_rate=0.01):
    """The harness's optimizer (fluid_benchmark.py:46)."""
    optimizer.Momentum(learning_rate=learning_rate,
                       momentum=0.9).minimize(loss)
