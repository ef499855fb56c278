"""ResNet with basic blocks: a ``stem_kernel`` conv with its bias, ReLU and
the requantization, then a max pool; per stage ``[width, blocks, stride]``
blocks of conv, ReLU and requantization, conv, the shortcut added (a 1x1
projection where the stride or the width changes), ReLU and the
requantization; then a global average pool and the dense head.  The convs
are named ``stem`` and ``stages.<s>.<b>.0.{c1,c2,proj}``."""

from __future__ import annotations

from .. import cnn


def conv_layers(config: dict) -> list[tuple[str, int, int, int, int]]:
    out = [("stem", config["stem_kernel"], config["in_channels"],
            config["stem_channels"], config["stem_stride"])]
    c, K = config["stem_channels"], config["conv_kernel"]
    for s, (cout, blocks, first) in enumerate(config["stages"]):
        for b in range(blocks):
            st, pre = (first if b == 0 else 1), f"stages.{s}.{b}.0"
            out += [(f"{pre}.c1", K, c, cout, st), (f"{pre}.c2", K, cout, cout, 1)]
            if st != 1 or c != cout:
                out.append((f"{pre}.proj", 1, c, cout, st))
            c = cout
    return out


def head_width(config: dict) -> int:
    return conv_layers(config)[-1][3]


def weight_shapes(config: dict) -> dict[str, tuple[int, ...]]:
    return cnn.biased_conv_shapes(config, conv_layers(config),
                                  head_width(config))


def forward(config: dict, weights: dict, images, conv, requant):
    b = weights
    x = requant(conv("stem", images, config["stem_stride"]) + b["stem.b"])
    x = cnn.maxpool(x, config["stem_pool_kernel"], config["stem_pool_stride"])
    c = config["stem_channels"]
    for s, (cout, blocks, first) in enumerate(config["stages"]):
        for i in range(blocks):
            st, pre = (first if i == 0 else 1), f"stages.{s}.{i}.0"
            y = requant(conv(pre + ".c1", x, st) + b[pre + ".c1.b"])
            y = conv(pre + ".c2", y, 1) + b[pre + ".c2.b"]
            if st != 1 or c != cout:
                x = y + (conv(pre + ".proj", x, st) + b[pre + ".proj.b"])
            else:
                x = y + x
            x = requant(x)
            c = cout
    return cnn.dense_head(x, b)
