"""The output check that decides a run's ``correct``.

A log-requantized net cannot be compared whole: a sum within float32
rounding of a half-step boundary takes the other code under another
summation order, and at full size such flips cascade, so two correct
versions' logits differ by percents.  So the reference follows the program
stage by stage.  Walking its own plan, it takes at each conv the program's
own input to that conv and holds three numbers against their limits:

``conv_gap``
    each conv's output against the plain conv of the same input with the
    weights quantized here from the float weights: the largest
    |difference| over the largest |reference|, worst conv.
``act_mismatch``
    each conv's input against what the plan makes of the program's
    previous outputs (bias, ReLU, requantization, pools, the shortcut
    add, whatever else the family's plan does; the images for the first
    conv): the share of elements that differ by more than ``ACT_RTOL`` of
    their value, worst conv.  A code taken one step off moves a value by a
    factor of sqrt(2); a channel scale a few ulps off (another float32
    order of the same sums) moves it by 1e-7.
``logit_gap``
    the logits that the timed window delivered against the plan's head
    over the program's last outputs: the largest |difference| over the
    largest |reference|.

A conv that the program did not run, or ran on other shapes, reads inf.
"""

from __future__ import annotations

import contextlib
import math

import torch

from . import cnn, logquant

NUMBERS = ("conv_gap", "act_mismatch", "logit_gap")
ACT_RTOL = 1e-5


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32 (the card would otherwise take TF32)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), as float32."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    """How the reference computes: ``tf32`` rounds every product's operands
    to TF32, ``quant_dtype`` runs the quantizer in that dtype.  The default
    is the configuration's float32; `CONTROL` is the nearest below it."""

    def __init__(self, tf32: bool = False, quant_dtype=None):
        self.tf32, self.quant_dtype = tf32, quant_dtype

    def operand(self, x):
        return round_tf32(x) if self.tf32 else x


FLOAT32 = Precision()
CONTROL = Precision(tf32=True, quant_dtype=torch.bfloat16)
# the control, and each of its two steps down alone
PRECISIONS = {"control": CONTROL, "tf32": Precision(tf32=True),
              "bf16_quant": Precision(quant_dtype=torch.bfloat16)}


def _lq(config):
    q = config["log_quant"]
    return dict(bits=q["bits"], frac_bits=q["frac_bits"],
                per_channel=q["per_channel"])


def quantized_weights(config, weights, prec: Precision = FLOAT32) -> dict:
    """Each conv kernel quantized per output channel and decoded, here."""
    return {name: logquant.fake_quant(weights[name + ".w"], **_lq(config),
                                      dtype=prec.quant_dtype)
            for name, *_ in cnn.conv_layers(config)}


def _conv(x, w, stride, prec):
    return cnn.conv_nhwc(prec.operand(x), prec.operand(w), stride)


def _requant(config, prec):
    """ReLU (unless ``relu`` is false) and the activations'
    quantize-dequantize: signed values keep their sign under the same
    per-channel scale rule."""
    lq = _lq(config)

    def requant(x, relu=True):
        return logquant.fake_quant(torch.relu(x) if relu else x, **lq,
                                   dtype=prec.quant_dtype)
    return requant


def _head(prec, weights):
    w = dict(weights)
    w["head.w"] = prec.operand(weights["head.w"])
    return w


def reference_forward(config, weights, images, prec: Precision = FLOAT32,
                      record: dict | None = None):
    """The plain forward from the images alone; with ``record`` each conv's
    (input, output) lands there by name, as the program's capture does."""
    wq = quantized_weights(config, weights, prec)

    def conv(name, x, stride):
        y = _conv(x, wq[name], stride, prec)
        if record is not None:
            record[name] = (x, y)
        return y

    with no_tf32():
        return cnn.forward(config, _head(prec, weights), images, conv,
                           _requant(config, prec))


def gap(got, want) -> float:
    if got is None or tuple(got.shape) != tuple(want.shape):
        return math.inf
    d = (got.float() - want.float()).abs().max()
    scale = want.float().abs().max()
    v = float(d / scale) if float(scale) > 0 else float(d)
    return v if math.isfinite(v) else math.inf


def _mismatch(got, want) -> float:
    if got is None or tuple(got.shape) != tuple(want.shape):
        return math.inf
    close = torch.isclose(got, want, rtol=ACT_RTOL, atol=0.0)
    return float((~close).float().mean())


def compare(config, weights, images, captured: dict, logits) -> dict:
    """The three numbers for one query: ``captured[name] = (input,
    output)`` of each conv as the program ran it, ``logits`` what the
    window delivered for these ``images``."""
    wq = quantized_weights(config, weights)
    out = {k: 0.0 for k in NUMBERS}
    seen = set()

    def conv(name, x_plan, stride):
        seen.add(name)
        x_prog, y_prog = captured.get(name, (None, None))
        out["act_mismatch"] = max(out["act_mismatch"],
                                  _mismatch(x_prog, x_plan))
        if x_prog is None or y_prog is None:
            out["conv_gap"] = math.inf
            return cnn.conv_nhwc(x_plan, wq[name], stride)
        y_ref = cnn.conv_nhwc(x_prog.float(), wq[name], stride)
        out["conv_gap"] = max(out["conv_gap"], gap(y_prog, y_ref))
        if tuple(y_prog.shape) != tuple(y_ref.shape):
            return y_ref
        return y_prog.float()

    with no_tf32():
        want = cnn.forward(config, weights, images, conv,
                           _requant(config, FLOAT32))
    if set(captured) - seen:
        out["conv_gap"] = math.inf
    out["logit_gap"] = gap(torch.as_tensor(logits).to(want.device), want)
    return out
