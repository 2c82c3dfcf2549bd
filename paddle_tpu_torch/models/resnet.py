"""ResNet (bottleneck) and SE-ResNeXt written with the port's layers.

Copy of paddle_tpu/models/resnet.py's ImageNet ResNet (the reference's
benchmark/fluid/resnet.py), trimmed to the bottleneck depths 50, 101
and 152, and its SE-ResNeXt (benchmark/fluid/se_resnext.py). Each builds
the same program as paddle_tpu's, op for op and name for name.
"""
from .. import layers

__all__ = ['resnet_imagenet', 'se_resnext']


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


def _squeeze_excitation(input, num_channels, reduction_ratio):
    pool = layers.pool2d(input=input, pool_type='avg', global_pooling=True)
    squeeze = layers.fc(input=pool, size=num_channels // reduction_ratio,
                        act='relu')
    excitation = layers.fc(input=squeeze, size=num_channels, act='sigmoid')
    return layers.elementwise_mul(x=input, y=excitation, axis=0)


def _se_bottleneck(input, num_filters, stride, cardinality, reduction_ratio,
                   ch_in, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, 1, 0, is_test=is_test)
    conv1 = layers.conv2d(input=conv0, num_filters=num_filters,
                          filter_size=3, stride=stride, padding=1,
                          groups=cardinality, act=None, bias_attr=False)
    conv1 = layers.batch_norm(input=conv1, act='relu', is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, 1, 0, act=None,
                          is_test=is_test)
    scale = _squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = shortcut(input, ch_in, num_filters * 2, stride, is_test)
    return layers.elementwise_add(x=short, y=scale, act='relu')


def se_resnext(input, class_dim, depth=50, is_test=False):
    """SE-ResNeXt-50/101/152: cardinality 32, reduction 16; its grouped
    3x3 convs replay in the fused_conv op (counted as 'groups')."""
    cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
    if depth not in cfg:
        raise ValueError("se_resnext builds depths %s, got %r"
                         % (sorted(cfg), depth))
    depth_cfg = cfg[depth]
    cardinality, reduction_ratio = 32, 16
    num_filters = [128, 256, 512, 1024]

    conv = conv_bn_layer(input, 64, 7, 2, 3, is_test=is_test)
    conv = layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                         pool_padding=1, pool_type='max')
    ch_in = 64
    for block in range(len(depth_cfg)):
        for i in range(depth_cfg[block]):
            conv = _se_bottleneck(conv, num_filters[block],
                                  2 if i == 0 and block != 0 else 1,
                                  cardinality, reduction_ratio, ch_in,
                                  is_test)
            ch_in = num_filters[block] * 2
    pool = layers.pool2d(input=conv, pool_size=7, pool_type='avg',
                         global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act='softmax')
