"""The system under test: the port's CNN entry on packed log codes.

This is the one module of the benchmark that imports the program
(`repro_torch`), and it takes only its entry points, its packing and its
launch counter.  Every import is inside a function, so that the harness's
other modules, the reference above all, load without it.
"""

from __future__ import annotations

import contextlib

import torch


def _leaves(tree, path=()):
    """(dotted path, leaf) of every leaf of a tree of dicts, lists and
    tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield ".".join(path), tree


def _fill(tree, weights: dict, path=()):
    """The program's parameter tree with every tensor leaf replaced by the
    benchmark's weight of the same path (and shape)."""
    if isinstance(tree, dict):
        return {k: _fill(v, weights, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, weights, path + (str(i),))
                          for i, v in enumerate(tree))
    if not isinstance(tree, torch.Tensor):
        return tree
    name = ".".join(path)
    w = weights.get(name)
    if w is None or tuple(w.shape) != tuple(tree.shape):
        raise ValueError(f"the program's parameter {name} {tuple(tree.shape)}"
                         f" has no weight of its shape in the configuration")
    return w


class Program:
    """The packed net and its forward, as the timed window calls it."""

    def __init__(self, config: dict, weights: dict):
        from repro_torch.core.logquant import LogQuantConfig
        from repro_torch.models.cnn import CNNS
        from repro_torch.serving.quantize import quantize_cnn_params
        lq = config["log_quant"]
        self.qcfg = LogQuantConfig(bits=lq["bits"], frac_bits=lq["frac_bits"],
                                   per_channel=lq["per_channel"])
        init, self.apply = CNNS[config["net"]]
        skeleton = init(None, n_classes=config["n_classes"],
                        cin=config["in_channels"], device="meta")
        used = {p for p, t in _leaves(skeleton) if isinstance(t, torch.Tensor)}
        if used != set(weights):
            raise ValueError(f"the configuration's weights and the program's "
                             f"parameters differ: {sorted(used ^ set(weights))}")
        self.packed = quantize_cnn_params(_fill(skeleton, weights), self.qcfg,
                                          conv_layout="lane_packed")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.apply(self.packed, x, quant="logq6", qcfg=self.qcfg,
                              conv_impl="auto")

    @contextlib.contextmanager
    def capture(self, record: dict):
        """Each conv that `kernels.ops.conv2d` runs lands in ``record`` as
        (input, output) under its layer's name (its weights' path)."""
        from repro_torch.kernels import ops
        names = {id(qt): path[:-len(".w")] for path, qt in _leaves(self.packed)
                 if path.endswith(".w")}
        conv = ops.conv2d

        def spy(x, qt, **kw):
            y = conv(x, qt, **kw)
            record[names.get(id(qt), f"unnamed{len(record)}")] = (x, y)
            return y

        ops.conv2d = spy
        try:
            yield record
        finally:
            ops.conv2d = conv


def conv_shapes(config: dict, batch: int) -> list[tuple]:
    """The program's own conv launches of one forward, as sorted
    (B, H, W, C, K, Cout, stride, groups), from its shape walk on ``meta``."""
    from repro_torch.models.cnn import trace_conv_shapes
    return sorted((r["B"], r["H"], r["W"], r["C"], r["K"], r["Cout"],
                   r["stride"], r["groups"])
                  for r in trace_conv_shapes(
                      config["net"], batch=batch, img=config["image_size"],
                      n_classes=config["n_classes"],
                      cin=config["in_channels"]))


def b1_launches() -> int:
    """Launches of the conv kernel (B1) so far in this process."""
    from repro_torch.kernels.log_conv2d import log_conv2d_fused
    return log_conv2d_fused.launches


def autotune_counters() -> dict:
    from repro_torch.obs.metrics import REGISTRY
    return {k: v for k, v in REGISTRY.snapshot()["counters"].items()
            if k.startswith("autotune")}
