"""Bit-exact fixed-point semantics of the NeuroMAX log-PE compute thread,
on int64 tensors (counterpart of `repro.core.logmath`).

Implements eqs. (5)-(8):

    w_q · a_q = sign(w_q) · 2^(g'),        g' = w' + a'            (5,6)
              = sign(w_q) · 2^INT(g) · 2^FRAC(g),  g = g'/2^n      (7)
              = sign(w_q) · (LUT(FRAC(g')) >> ¬INT(g'))            (8)

where w', a' are integer log codes in 1/2^n-octave units.  The LUT holds the
2^n fractional powers 2^(f/2^n) as fixed-point integers with F fractional
bits; the shift realises the integer part of the exponent.  This module is
the oracle for the hardware: `core/pe_grid.py` uses it so the grid model
computes exactly what the RTL would.

`log_product_fixed` is one thread on Python ints; `log_product_fixed_batch`
is the same LUT+shift on whole int64 tensors on one device, the card's or
the CPU's.
"""

from __future__ import annotations

import torch

from .device import resolve_device

__all__ = ["LogPEThread", "log_product_fixed", "log_product_fixed_batch",
           "make_frac_lut"]


def _frac_lut_values(frac_bits: int, out_frac_bits: int) -> list[int]:
    steps = 1 << frac_bits
    return [int(round((2.0 ** (f / steps)) * (1 << out_frac_bits)))
            for f in range(steps)]


def make_frac_lut(frac_bits: int, out_frac_bits: int,
                  device=None) -> torch.Tensor:
    """The pre-computed fractional table stored in each thread (2^n entries).

    Paper: "we have n = 1 and thus store 2^n = 2 values in the thread memory."
    Entry f holds round(2^(f / 2^n) · 2^F) for f in [0, 2^n), as int64 on
    ``device`` (default: the card).
    """
    return torch.tensor(_frac_lut_values(frac_bits, out_frac_bits),
                        dtype=torch.int64, device=resolve_device(device))


def log_product_fixed(w_code: int, a_code: int, w_sign: int,
                      frac_bits: int = 1, out_frac_bits: int = 12) -> int:
    """Eq. (8): one thread's product as a fixed-point integer (F frac bits).

    w_code, a_code : integer log codes in 1/2^n-octave units (may be negative)
    w_sign         : ±1 (the paper's w'[6]; activations are post-ReLU ≥ 0)
    returns        : integer v such that the real value is v / 2^F
    """
    steps = 1 << frac_bits
    g = int(w_code) + int(a_code)                       # eq. (6), integer add
    int_part = g >> frac_bits                           # floor(g / 2^n)
    frac_part = g & (steps - 1)                         # g mod 2^n  (≥ 0)
    v = _frac_lut_values(frac_bits, out_frac_bits)[frac_part]
    if int_part >= 0:
        v <<= int_part                                  # 2^INT, left shift
    else:
        v >>= -int_part                                 # ">> ¬INT" of eq. (8)
    return int(w_sign) * v


def log_product_fixed_batch(w_codes, a_codes, w_signs=1, a_nonzero=True,
                            w_nonzero=True, frac_bits: int = 1,
                            out_frac_bits: int = 12,
                            lut: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. (8) over whole tensors at once: the same LUT+barrel-shift per
    element as `log_product_fixed`, broadcast with int64 ops on the device of
    ``lut`` (or, without one, of the codes).

    Bit-identical to the scalar path whenever the shifted product fits
    int64, i.e. INT(g) ≤ 62 − (F+1) for a 2^(F+1)-bounded LUT value (the
    scalar path promotes to unbounded Python ints); any ⟨6,1⟩ quantizer
    emits codes ≤ 0, so every grid product only shifts right.
    """
    a_codes = torch.as_tensor(a_codes)
    device = lut.device if lut is not None else a_codes.device
    if lut is None:
        lut = make_frac_lut(frac_bits, out_frac_bits, device)
    g = (torch.as_tensor(w_codes, device=device).to(torch.int64)
         + a_codes.to(device=device, dtype=torch.int64))
    v = lut[g & ((1 << frac_bits) - 1)]
    int_part = g >> frac_bits
    # one of the two shifts is always by 0; a shift by 64 or more is
    # undefined (on the card too), so the counts are clipped to 62, and a
    # LUT value < 2^(F+1) shifted right by 62 is exactly 0 anyway
    v = (v << int_part.clamp(0, 62)) >> (-int_part).clamp(0, 62)
    out = torch.as_tensor(w_signs, device=device).to(torch.int64) * v
    mask = (torch.as_tensor(a_nonzero, device=device)
            & torch.as_tensor(w_nonzero, device=device))
    return torch.where(mask, out, torch.zeros((), dtype=torch.int64,
                                              device=device))


class LogPEThread:
    """One compute thread of a PE (Fig. 3a): code adder + LUT + barrel shift.
    Its LUT lives on ``device`` (default: the card), where `batch`
    computes."""

    def __init__(self, frac_bits: int = 1, out_frac_bits: int = 12,
                 device=None):
        self.frac_bits = frac_bits
        self.out_frac_bits = out_frac_bits
        self.lut = make_frac_lut(frac_bits, out_frac_bits, device)

    def __call__(self, w_code, a_code, w_sign=1, a_nonzero=True,
                 w_nonzero=True):
        if not (a_nonzero and w_nonzero):
            return 0
        return log_product_fixed(w_code, a_code, w_sign,
                                 self.frac_bits, self.out_frac_bits)

    def batch(self, w_codes, a_codes, w_signs=1, a_nonzero=True,
              w_nonzero=True) -> torch.Tensor:
        """Vectorised `__call__` over broadcastable tensors (shared LUT)."""
        return log_product_fixed_batch(w_codes, a_codes, w_signs, a_nonzero,
                                       w_nonzero, self.frac_bits,
                                       self.out_frac_bits, lut=self.lut)

    def to_float(self, v: int) -> float:
        return v / float(1 << self.out_frac_bits)

    def closed_form(self, w_code, a_code, w_sign=1) -> float:
        """sign · 2^((w'+a')/2^n) — what eq. (5) says the product should be."""
        steps = 1 << self.frac_bits
        return w_sign * 2.0 ** ((w_code + a_code) / steps)
