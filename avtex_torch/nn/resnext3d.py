"""3D ResNeXt video encoders (the port of avtex/nn/resnext3d.py).

``ResNet3D`` with ``ResNeXtBottleneck3D`` blocks: a 1^3 reduce to the
stage's width, a 3^3 conv in 32 groups, a 1^3 expand by 2. avtex doubles
the mid width by giving the net ``width = 128`` (its ``Bottleneck3D``
runs the grouped conv at ``features`` channels and expands by the
block's ``expansion``), so the stages run 128/256/512/1024 mid channels
into 256/512/1024/2048 and ``feat_dim = 128 * 8 * 2 = 2048``. The stem
keeps 64 channels. Registered as ``resnext50/101/152``; ``remat`` as in
``ResNet3D``.
"""

from __future__ import annotations

import functools

from .resnet3d import Bottleneck3D, ResNet3D


class ResNeXtBottleneck3D(Bottleneck3D):
    """Bottleneck with a grouped 3^3 conv and expansion 2."""

    expansion = 2


ResNeXt3D = functools.partial(ResNet3D, block=ResNeXtBottleneck3D,
                              groups=32, width=128)

resnext3d50 = functools.partial(ResNeXt3D, layers=(3, 4, 6, 3))
resnext3d101 = functools.partial(ResNeXt3D, layers=(3, 4, 23, 3))
resnext3d152 = functools.partial(ResNeXt3D, layers=(3, 8, 36, 3))
