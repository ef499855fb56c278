"""The paper's own workload: log-quantized CNN inference on the NeuroMAX
grid.  Not one of the 10 assigned LM architectures — this config drives the
faithful-reproduction benchmarks (Figs 17/19/20, Tables 2/3) and the CNN
training example.
"""

from __future__ import annotations

import dataclasses

from ..core.logquant import LogQuantConfig


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "neuromax-cnn"
    network: str = "vgg16"          # vgg16|mobilenet_v1|resnet34|squeezenet
    img: int = 224
    n_classes: int = 1000
    cin: int = 3
    width_mult: float = 1.0
    quant: str | None = "logq6"     # paper numerics by default
    qcfg: LogQuantConfig = LogQuantConfig()

    def reduced(self, **over):
        kw = dict(img=32, n_classes=10, width_mult=0.125)
        kw.update(over)
        return dataclasses.replace(self, **kw)


CONFIG = CNNConfig()
