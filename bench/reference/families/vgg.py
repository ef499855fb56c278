"""VGG: SAME ``conv_kernel`` convs at ``conv_stride``, each followed by its
bias, ReLU and the requantization, and a max pool where the configuration's
``convs`` entry says so; then a global average pool and the dense head.
The convs are named ``convs.<i>``."""

from __future__ import annotations

from .. import cnn


def conv_layers(config: dict) -> list[tuple[str, int, int, int, int]]:
    c, out = config["in_channels"], []
    for i, (cout, _) in enumerate(config["convs"]):
        out.append((f"convs.{i}", config["conv_kernel"], c, cout,
                    config["conv_stride"]))
        c = cout
    return out


def head_width(config: dict) -> int:
    return conv_layers(config)[-1][3]


def weight_shapes(config: dict) -> dict[str, tuple[int, ...]]:
    return cnn.biased_conv_shapes(config, conv_layers(config),
                                  head_width(config))


def forward(config: dict, weights: dict, images, conv, requant):
    b, x = weights, images
    for i, (_, pool) in enumerate(config["convs"]):
        name = f"convs.{i}"
        x = requant(conv(name, x, config["conv_stride"]) + b[name + ".b"])
        if pool:
            x = cnn.maxpool(x, config["pool_kernel"], config["pool_stride"])
    return cnn.dense_head(x, b)
