"""ResNet (bottleneck) written with the port's layers.

Copy of paddle_tpu/models/resnet.py's ImageNet ResNet (the reference's
benchmark/fluid/resnet.py), trimmed to the bottleneck depths 50, 101
and 152. It builds the same program as paddle_tpu's resnet_imagenet, op for op
and name for name.
"""
from .. import layers

__all__ = ['resnet_imagenet']


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act='relu',
                  is_test=False):
    conv = layers.conv2d(input=input, filter_size=filter_size,
                         num_filters=ch_out, stride=stride, padding=padding,
                         act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def shortcut(input, ch_in, ch_out, stride, is_test=False):
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None,
                             is_test=is_test)
    return input


def bottleneck(input, ch_in, ch_out, stride, is_test=False):
    short = shortcut(input, ch_in, ch_out * 4, stride, is_test)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test)
    return layers.elementwise_add(x=short, y=conv3, act='relu')


def layer_warp(block_func, input, ch_in, ch_out, count, stride,
               is_test=False):
    res_out = block_func(input, ch_in, ch_out, stride, is_test)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out * 4, ch_out, 1, is_test)
    return res_out


def resnet_imagenet(input, class_dim, depth=50, is_test=False):
    """ResNet-``depth`` for ImageNet: the 7x7 stride-2 stem, a 3x3 max
    pool, four stages of bottleneck blocks, a global average pool and
    an fc with softmax over ``class_dim`` classes."""
    cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
    if depth not in cfg:
        raise ValueError("resnet_imagenet builds depths %s, got %r"
                         % (sorted(cfg), depth))
    stages = cfg[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, is_test=is_test)
    pool1 = layers.pool2d(input=conv1, pool_type='max', pool_size=3,
                          pool_stride=2, pool_padding=1)
    res1 = layer_warp(bottleneck, pool1, 64, 64, stages[0], 1, is_test)
    res2 = layer_warp(bottleneck, res1, 256, 128, stages[1], 2, is_test)
    res3 = layer_warp(bottleneck, res2, 512, 256, stages[2], 2, is_test)
    res4 = layer_warp(bottleneck, res3, 1024, 512, stages[3], 2, is_test)
    pool2 = layers.pool2d(input=res4, pool_size=7, pool_type='avg',
                          global_pooling=True)
    return layers.fc(input=pool2, size=class_dim, act='softmax')
