"""The networks the paper benchmarks (VGG-16, MobileNet v1, ResNet-34,
SqueezeNet) in PyTorch, with optional base-√2 log fake-quant on conv
weights and post-ReLU activations (paper §3).

Counterpart of `repro.models.cnn`: the same layer plans, NHWC activations,
HWIO conv kernels and parameter trees (plain dicts and lists of tensors;
ResNet's blocks are ``(block, stride)`` tuples).  Two knobs:

  * ``quant="logq6"`` inserts `fake_log_quant` (straight-through) on conv
    weights and post-ReLU activations, the QAT path;
  * ``conv_impl="cuda"|"blockwise"|"ref"|"auto"`` routes every conv through
    `kernels/ops.conv2d` on packed int8 log codes (packed once at load by
    `serving.quantize.quantize_cnn_params`, or per call), the deployed
    numerics.  "auto" runs the CUDA kernel on the card.

`make_cnn` builds on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.core.logquant import DEFAULT as LOGQ_DEFAULT
from repro_torch.core.logquant import (LogQuantConfig, QuantizedTensor,
                                       fake_log_quant, quantize_tensor)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.log_conv2d import conv_nhwc, normalize_padding

# ---------------------------------------------------------------------------
# quant-aware primitives
# ---------------------------------------------------------------------------


def _maybe_fq(w, quant: str | None, cfg: LogQuantConfig):
    return fake_log_quant(w, cfg) if quant == "logq6" else w


def conv2d(p, x, *, stride=1, pad="SAME", quant=None, qcfg=LOGQ_DEFAULT,
           groups=1, conv_impl=None):
    """x: [B, H, W, Cin]; p['w']: [K, K, Cin//groups, Cout] (float tensor or
    packed `QuantizedTensor`).

    With ``conv_impl`` set (or a packed weight) the conv dispatches to
    `kernels.ops.conv2d` on int8 log codes; otherwise it is the fake-quant
    float conv of the QAT path."""
    w = p["w"]
    if _CONV_SHAPE_TRACE is not None:
        hwio = tuple(w.shape)  # QuantizedTensor.shape is the logical HWIO
        _CONV_SHAPE_TRACE.append(dict(
            B=int(x.shape[0]), H=int(x.shape[1]), W=int(x.shape[2]),
            C=int(x.shape[3]), K=int(hwio[0]), Cout=int(hwio[-1]),
            stride=int(stride), padding=pad, groups=int(groups)))
    if conv_impl is not None or isinstance(w, QuantizedTensor):
        qt = w if isinstance(w, QuantizedTensor) else quantize_tensor(w, qcfg)
        y = kops.conv2d(x, qt, stride=stride, padding=pad, groups=groups,
                        impl=conv_impl or "auto", out_dtype=x.dtype)
    else:
        w = _maybe_fq(w, quant, qcfg)
        pads = normalize_padding(pad, w.shape[0], stride, x.shape[1],
                                 x.shape[2])
        y = conv_nhwc(x, w, stride=stride, pads=pads, groups=groups)
    if "b" in p:
        y = y + p["b"]
    return y


def _randn(gen, shape, device):
    if torch.device(device).type == "meta":  # shape tracing: no values
        return torch.empty(shape, device=device)
    # drawn on the CPU, so that a seed gives the same weights on every device
    return torch.randn(shape, generator=gen).to(device)


def conv_init(gen, k, cin, cout, groups=1, *, device="cpu"):
    fan_in = k * k * cin // groups
    w = _randn(gen, (k, k, cin // groups, cout), device)
    return {"w": w * (2.0 / fan_in) ** 0.5,
            "b": torch.zeros((cout,), device=device)}


def _head_init(gen, c, n_classes, device):
    return {"w": _randn(gen, (c, n_classes), device) * (1 / c) ** 0.5,
            "b": torch.zeros((n_classes,), device=device)}


def relu_q(x, quant=None, qcfg=LOGQ_DEFAULT):
    """ReLU then (optionally) log-requantize: the paper's post-processing
    block (ReLU + log-table requantization before writing back to DDR)."""
    x = torch.relu(x)
    return _maybe_fq(x, quant, qcfg) if quant == "logq6" else x


def avgpool_global(x):
    return x.mean(dim=(1, 2))


def maxpool(x, k=2, s=2):
    """VALID max pooling (a window never overhangs the edge, as XLA's
    `reduce_window` with a −inf init)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, s)
    return y.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# VGG-16
# ---------------------------------------------------------------------------

_VGG_PLAN = [  # (Cout, pool_after)
    (64, False), (64, True), (128, False), (128, True),
    (256, False), (256, False), (256, True),
    (512, False), (512, False), (512, True),
    (512, False), (512, False), (512, True),
]


def vgg16_init(gen, *, n_classes=1000, cin=3, width_mult=1.0, device="cpu"):
    params, c = [], cin
    for cout, _ in _VGG_PLAN:
        cout = max(8, int(cout * width_mult))
        params.append(conv_init(gen, 3, c, cout, device=device))
        c = cout
    return {"convs": params, "head": _head_init(gen, c, n_classes, device)}


def vgg16_apply(params, x, *, quant=None, qcfg=LOGQ_DEFAULT, conv_impl=None):
    cv = functools.partial(conv2d, quant=quant, qcfg=qcfg,
                           conv_impl=conv_impl)
    for p, (_, pool) in zip(params["convs"], _VGG_PLAN):
        x = relu_q(cv(p, x), quant, qcfg)
        if pool and min(x.shape[1], x.shape[2]) >= 2:
            x = maxpool(x)
    x = avgpool_global(x)
    return x @ params["head"]["w"] + params["head"]["b"]


# ---------------------------------------------------------------------------
# MobileNet v1 (depthwise separable: the paper's separable mode)
# ---------------------------------------------------------------------------

_MBN_PAIRS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)] + \
             [(512, 1)] * 5 + [(1024, 2), (1024, 1)]


def mobilenet_v1_init(gen, *, n_classes=1000, cin=3, width_mult=1.0,
                      device="cpu"):
    c0 = max(8, int(32 * width_mult))
    params = {"stem": conv_init(gen, 3, cin, c0, device=device), "pairs": []}
    c = c0
    for cout, _ in _MBN_PAIRS:
        cout = max(8, int(cout * width_mult))
        dw = conv_init(gen, 3, c, c, groups=c, device=device)
        pw = conv_init(gen, 1, c, cout, device=device)
        params["pairs"].append({"dw": dw, "pw": pw})
        c = cout
    params["head"] = _head_init(gen, c, n_classes, device)
    return params


def mobilenet_v1_apply(params, x, *, quant=None, qcfg=LOGQ_DEFAULT,
                       conv_impl=None):
    cv = functools.partial(conv2d, quant=quant, qcfg=qcfg,
                           conv_impl=conv_impl)
    x = relu_q(cv(params["stem"], x, stride=2), quant, qcfg)
    for pair, (_, stride) in zip(params["pairs"], _MBN_PAIRS):
        c = x.shape[-1]
        x = relu_q(cv(pair["dw"], x, stride=stride, groups=c), quant, qcfg)
        x = relu_q(cv(pair["pw"], x), quant, qcfg)
    x = avgpool_global(x)
    return x @ params["head"]["w"] + params["head"]["b"]


# ---------------------------------------------------------------------------
# ResNet-34
# ---------------------------------------------------------------------------

_R34_STAGES = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]


def resnet34_init(gen, *, n_classes=1000, cin=3, width_mult=1.0,
                  device="cpu"):
    c0 = max(8, int(64 * width_mult))
    params = {"stem": conv_init(gen, 5, cin, c0, device=device), "stages": []}
    cin_cur = c0
    for cout, nblocks, first_stride in _R34_STAGES:
        cout = max(8, int(cout * width_mult))
        stage = []
        for b in range(nblocks):
            st = first_stride if b == 0 else 1
            blk = {"c1": conv_init(gen, 3, cin_cur, cout, device=device),
                   "c2": conv_init(gen, 3, cout, cout, device=device)}
            if st != 1 or cin_cur != cout:
                blk["proj"] = conv_init(gen, 1, cin_cur, cout, device=device)
            stage.append((blk, st))
            cin_cur = cout
        params["stages"].append(stage)
    params["head"] = _head_init(gen, cin_cur, n_classes, device)
    return params


def resnet34_apply(params, x, *, quant=None, qcfg=LOGQ_DEFAULT,
                   conv_impl=None):
    cv = functools.partial(conv2d, quant=quant, qcfg=qcfg,
                           conv_impl=conv_impl)
    x = relu_q(cv(params["stem"], x, stride=2), quant, qcfg)
    if min(x.shape[1], x.shape[2]) >= 2:
        x = maxpool(x)
    for stage in params["stages"]:
        for blk, st in stage:
            y = relu_q(cv(blk["c1"], x, stride=st), quant, qcfg)
            y = cv(blk["c2"], y)
            sc = cv(blk["proj"], x, stride=st) if "proj" in blk else x
            x = relu_q(y + sc, quant, qcfg)
    x = avgpool_global(x)
    return x @ params["head"]["w"] + params["head"]["b"]


# ---------------------------------------------------------------------------
# SqueezeNet v1.0 (the Fig-1 net)
# ---------------------------------------------------------------------------

_FIRES = [(96, 16, 64), (128, 16, 64), (128, 32, 128), (256, 32, 128),
          (256, 48, 192), (384, 48, 192), (384, 64, 256), (512, 64, 256)]


def squeezenet_init(gen, *, n_classes=1000, cin=3, width_mult=1.0,
                    device="cpu"):
    m = lambda c: max(4, int(c * width_mult))  # noqa: E731
    params = {"stem": conv_init(gen, 5, cin, m(96), device=device),
              "fires": []}
    for cin_f, sq, ex in _FIRES:
        params["fires"].append({
            "squeeze": conv_init(gen, 1, m(cin_f), m(sq), device=device),
            "e1": conv_init(gen, 1, m(sq), m(ex), device=device),
            "e3": conv_init(gen, 3, m(sq), m(ex), device=device)})
    params["final"] = conv_init(gen, 1, m(512), n_classes, device=device)
    return params


def squeezenet_apply(params, x, *, quant=None, qcfg=LOGQ_DEFAULT,
                     conv_impl=None):
    cv = functools.partial(conv2d, quant=quant, qcfg=qcfg,
                           conv_impl=conv_impl)
    x = relu_q(cv(params["stem"], x, stride=2), quant, qcfg)
    if min(x.shape[1], x.shape[2]) >= 2:
        x = maxpool(x, 3, 2)
    for i, fire in enumerate(params["fires"]):
        if i in (3, 7) and min(x.shape[1], x.shape[2]) >= 2:
            x = maxpool(x, 3, 2)
        s = relu_q(cv(fire["squeeze"], x), quant, qcfg)
        e1 = relu_q(cv(fire["e1"], s), quant, qcfg)
        e3 = relu_q(cv(fire["e3"], s), quant, qcfg)
        x = torch.cat([e1, e3], dim=-1)
    x = relu_q(cv(params["final"], x), quant, qcfg)
    return avgpool_global(x)


# ---------------------------------------------------------------------------
# registry, construction, loss
# ---------------------------------------------------------------------------

CNNS = {
    "vgg16": (vgg16_init, vgg16_apply),
    "mobilenet_v1": (mobilenet_v1_init, mobilenet_v1_apply),
    "resnet34": (resnet34_init, resnet34_apply),
    "squeezenet": (squeezenet_init, squeezenet_apply),
}

CNN_ZOO = CNNS  # the paper's four networks


def make_cnn(name: str, seed: int = 0, *, n_classes=1000, cin=3,
             width_mult=1.0, quant=None, qcfg=LOGQ_DEFAULT, conv_impl=None,
             device=None):
    """Random weights from ``seed`` (the same on every device) on
    ``device`` (default: the card) → ``(params, apply)`` with
    ``apply(params, x)`` giving logits."""
    device = resolve_device(device)
    init, apply = CNNS[name]
    gen = (None if device.type == "meta"
           else torch.Generator().manual_seed(seed))
    params = init(gen, n_classes=n_classes, cin=cin, width_mult=width_mult,
                  device=device)
    return params, functools.partial(apply, quant=quant, qcfg=qcfg,
                                     conv_impl=conv_impl)


def params_from_numpy(tree, device=None):
    """A parameter tree of numpy arrays (e.g. a JAX tree converted with
    ``np.asarray``) → the same tree of fp32 tensors on ``device`` (default:
    the card).  Dicts, lists and tuples keep their type; integer scalars
    (ResNet's block strides, also as 0-d integer arrays) become Python
    ints."""
    device = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(conv(v) for v in a)
        a = np.array(a)
        if a.ndim == 0 and np.issubdtype(a.dtype, np.integer):
            return int(a)
        return torch.as_tensor(a.astype(np.float32), device=device)

    return conv(tree)


def cnn_loss(apply_fn, params, batch):
    logits = apply_fn(params, batch["images"])
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(-1, batch["labels"][:, None])
    acc = (logits.argmax(-1) == batch["labels"]).float().mean()
    return nll.mean(), {"acc": acc}


# ---------------------------------------------------------------------------
# conv-shape walker
# ---------------------------------------------------------------------------

_CONV_SHAPE_TRACE: list | None = None


@contextlib.contextmanager
def _capture_conv_shapes(records: list):
    global _CONV_SHAPE_TRACE
    prev = _CONV_SHAPE_TRACE
    _CONV_SHAPE_TRACE = records
    try:
        yield records
    finally:
        _CONV_SHAPE_TRACE = prev


def trace_conv_shapes(name: str, *, batch=1, img=224, n_classes=1000, cin=3,
                      width_mult=1.0) -> list[dict]:
    """Every conv dispatch of one zoo network, as launch-geometry records
    ``{B, H, W, C, K, Cout, stride, padding, groups}`` in call order.

    Runs on ``torch.device("meta")`` (the role `jax.eval_shape` plays in the
    JAX package): no parameter or activation is ever materialised."""
    params, apply = make_cnn(name, n_classes=n_classes, cin=cin,
                             width_mult=width_mult, device="meta")
    records: list[dict] = []
    with _capture_conv_shapes(records):
        apply(params, torch.empty((batch, img, img, cin), device="meta"))
    return records


def zoo_conv_shapes(*, batch=1, img=224, n_classes=1000, cin=3,
                    width_mult=1.0) -> list[dict]:
    """Deduped union of conv launch shapes across the zoo (each record gains
    a ``nets`` list naming the networks that dispatch it)."""
    seen: dict[tuple, dict] = {}
    for name in CNNS:
        for r in trace_conv_shapes(name, batch=batch, img=img,
                                   n_classes=n_classes, cin=cin,
                                   width_mult=width_mult):
            sig = tuple(sorted((k, str(v)) for k, v in r.items()))
            if sig not in seen:
                seen[sig] = dict(r, nets=[name])
            elif name not in seen[sig]["nets"]:
                seen[sig]["nets"].append(name)
    return list(seen.values())
