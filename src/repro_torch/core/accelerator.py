"""Whole-CNN walk of the NeuroMAX accelerator model (§6, Figs. 19/20, Tables 2/3),
counterpart of `repro.core.accelerator`.

Defines the layer graphs of the CNNs the paper benchmarks (VGG-16,
MobileNet v1, ResNet-34; plus SqueezeNet for the Fig-1 nets) and runs them
through the analytical dataflow model in `core/dataflow.py`.
"""

from __future__ import annotations

from .dataflow import LayerSpec, NetworkPerf, analyze_network

__all__ = ["vgg16_layers", "mobilenet_v1_layers", "resnet34_layers",
           "squeezenet_layers", "run_network", "NETWORKS"]


def vgg16_layers(img: int = 224) -> list:
    """The 13 conv layers of VGG-16 (pad 1, stride 1, 3×3)."""
    cfg = [  # (name, C_in, C_out, spatial)
        ("CONV1_1", 3, 64, img), ("CONV1_2", 64, 64, img),
        ("CONV2_1", 64, 128, img // 2), ("CONV2_2", 128, 128, img // 2),
        ("CONV3_1", 128, 256, img // 4), ("CONV3_2", 256, 256, img // 4),
        ("CONV3_3", 256, 256, img // 4),
        ("CONV4_1", 256, 512, img // 8), ("CONV4_2", 512, 512, img // 8),
        ("CONV4_3", 512, 512, img // 8),
        ("CONV5_1", 512, 512, img // 16), ("CONV5_2", 512, 512, img // 16),
        ("CONV5_3", 512, 512, img // 16),
    ]
    return [LayerSpec(n, "conv", s, s, c, p, K=3, stride=1, pad=1)
            for n, c, p, s in cfg]


def mobilenet_v1_layers(img: int = 224) -> list:
    """MobileNet v1: first full conv then 13 dw/pw pairs."""
    layers = [LayerSpec("CONV1", "conv", img, img, 3, 32, K=3, stride=2, pad=1)]
    # (C_in, C_out, stride) for each dw/pw pair
    pairs = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
             (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
            [(512, 1024, 2), (1024, 1024, 1)]
    s = img // 2
    for i, (cin, cout, st) in enumerate(pairs):
        layers.append(LayerSpec(f"DW{i+1}", "dwconv", s, s, cin, cin,
                                K=3, stride=st, pad=1))
        s_out = s // st
        layers.append(LayerSpec(f"PW{i+1}", "pwconv", s_out, s_out, cin, cout, K=1))
        s = s_out
    return layers


def resnet34_layers(img: int = 224) -> list:
    """ResNet-34 conv layers (7×7 stem approximated as the paper does by the
    grid's multi-cycle higher-order path; basic blocks are 3×3)."""
    layers = [LayerSpec("CONV1", "conv", img, img, 3, 64, K=5, stride=2, pad=2)]
    s = img // 4  # after stem stride-2 conv + stride-2 maxpool
    stages = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
    cin = 64
    for si, (c, blocks, first_stride) in enumerate(stages):
        for b in range(blocks):
            st = first_stride if b == 0 else 1
            layers.append(LayerSpec(f"S{si+1}B{b+1}a", "conv", s, s, cin, c,
                                    K=3, stride=st, pad=1))
            s = s // st
            layers.append(LayerSpec(f"S{si+1}B{b+1}b", "conv", s, s, c, c,
                                    K=3, stride=1, pad=1))
            if b == 0 and (st != 1 or cin != c):  # projection shortcut
                layers.append(LayerSpec(f"S{si+1}B{b+1}p", "pwconv",
                                        s * st, s * st, cin, c, K=1, stride=st))
            cin = c
    return layers


def squeezenet_layers(img: int = 224) -> list:
    """SqueezeNet v1.0 fire modules (squeeze 1×1, expand 1×1 + 3×3)."""
    layers = [LayerSpec("CONV1", "conv", img, img, 3, 96, K=5, stride=2, pad=2)]
    s = img // 4
    fires = [(96, 16, 64), (128, 16, 64), (128, 32, 128),
             (256, 32, 128), (256, 48, 192), (384, 48, 192),
             (384, 64, 256), (512, 64, 256)]
    pool_after = {0: None}
    for i, (cin, sq, ex) in enumerate(fires):
        if i == 3:
            s //= 2
        if i == 7:
            s //= 2
        layers.append(LayerSpec(f"F{i+2}s", "pwconv", s, s, cin, sq, K=1))
        layers.append(LayerSpec(f"F{i+2}e1", "pwconv", s, s, sq, ex, K=1))
        layers.append(LayerSpec(f"F{i+2}e3", "conv", s, s, sq, ex,
                                K=3, stride=1, pad=1))
    layers.append(LayerSpec("CONV10", "pwconv", s, s, 512, 1000, K=1))
    return layers


NETWORKS = {
    "vgg16": vgg16_layers,
    "mobilenet_v1": mobilenet_v1_layers,
    "resnet34": resnet34_layers,
    "squeezenet": squeezenet_layers,
}


def run_network(name: str, img: int = 224) -> NetworkPerf:
    return analyze_network(name, NETWORKS[name](img))
