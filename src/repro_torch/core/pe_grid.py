"""Functional model of the NeuroMAX 6×3×6 PE grid + adder nets (§4-5), on
torch tensors (counterpart of `repro.core.pe_grid`).

This computes real convolution outputs the way the RTL does, so the wiring
(2D weight broadcast, adder-net-0 row reduction, adder-net-1 column combine,
variable-length shift-register boundary psums) is testable against a dense
convolution, and the conv kernel is testable against the hardware.

Grid geometry (Fig. 2/3):
    6 PE matrices × (6 rows × 3 cols) PEs × 3 threads  = 324 threads.
For a 3×3 conv, one matrix processes one input channel:
  * a 6-row × 3-col input window (row-shifted per Fig. 6) enters the matrix;
  * the 3×3 weight matrix is broadcast: PE column c holds weight row c,
    its 3 threads multiply one input pixel by the 3 weights of that row;
  * adder-net-0 (Fig. 4) sums same-coloured products along each PE row,
    producing 18 psums o_{r,k} = Σ_dc x[r, j+dc]·w[k, dc]  (r∈0..5, k∈0..2);
  * adder-net-1 (Fig. 9) combines psums across rows into outputs
        y[r, j] = o_{r,0} + o_{r+1,1} + o_{r+2,2};
    rows 4,5 of a band need psums from the next band: exactly the three
    boundary psums (o13, o17, o16) the paper passes through the VAR-len SR.

Two compute modes:
  * mode="float": thread product = w·a in float64 (isolates the dataflow
    wiring: exact against a direct convolution up to rounding);
  * mode="log":   thread product = the fixed-point LUT+shift of
    `core.logmath` on log-quantized codes, integer psums (bit-exact against
    what the FPGA would produce), scaled to float64 once a psum block.

Both modes are vectorised: every thread product of many bands, column
positions, channel groups and filters is one `PEMatrix.cycle_psums_batch`
call, the boundary shift register is a shifted add along the band axis whose
last band carries into the next chunk, and the counts are closed forms of
the JAX package's per-cycle loops, which are the reference its tests hold
this grid to.  Chunks of at most `CHUNK` thread products bound the memory,
which lets the oracle run VGG-16's layers at 224 px on the card.

The grid runs on the card unless the caller passes ``device="cpu"``.  It is
the bottom tier of the port's three-tier conv stack: `kernels/ops.conv2d`'s
CUDA kernel ↔ its plain `log_conv2d_blockwise` ↔ this hardware oracle.
"""

from __future__ import annotations

import dataclasses

import torch

from .device import resolve_device
from .logmath import LogPEThread
from .logquant import LogQuantConfig, log_dequantize, log_quantize, unpack

N_MATRICES = 6
PE_ROWS = 6
PE_COLS = 3
THREADS = 3
TOTAL_THREADS = N_MATRICES * PE_ROWS * PE_COLS * THREADS  # 324

CHUNK = 1 << 24  # thread products one vectorised step holds at once


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fit(n: int, budget: int) -> int:
    """How many of ``n`` items fit ``budget`` (at least one)."""
    return min(n, max(1, budget))


def _spans(n: int, size: int):
    return ((a, min(a + size, n)) for a in range(0, n, size))


@dataclasses.dataclass
class GridStats:
    cycles: int = 0
    useful_macs: int = 0
    stored_psums: int = 0
    total_psums: int = 0
    active_thread_cycles: int = 0  # threads of matrices that held data

    @property
    def utilization(self) -> float:
        """Whole-grid utilization (idle matrices count — Fig 19 semantics)."""
        if self.cycles == 0:
            return 0.0
        return self.useful_macs / (self.cycles * TOTAL_THREADS)

    @property
    def active_utilization(self) -> float:
        """Utilization w.r.t. matrices actually loaded (§5.1/§5.2 examples)."""
        if self.active_thread_cycles == 0:
            return 0.0
        return self.useful_macs / self.active_thread_cycles

    @property
    def psum_storage_fraction(self) -> float:
        if self.total_psums == 0:
            return 0.0
        return self.stored_psums / self.total_psums


class PEMatrix:
    """One 6×3 PE matrix + its adder-net-0: emits 18 psums per cycle."""

    def __init__(self, mode: str = "float", thread: LogPEThread | None = None):
        self.mode = mode
        self.thread = thread or LogPEThread()

    def cycle_psums_batch(self, windows, ws, window_codes=None, w_codes=None,
                          w_signs=None):
        """The 18 psums of many matrix cycles at once.

        windows: [..., 6, 3] input pixels (cols j..j+2); ws: [..., 3, 3]
        weight rows (one matrix per leading index; the leading dims
        broadcast).  Returns o[..., r, k] = Σ_dc window[r, dc] · w[k, dc]
        — shape [..., 6, 3]; the caller channel-accumulates (Fig. 13) or
        keeps them separate (depthwise).  In log mode each thread product
        is the fixed-point LUT+shift of `LogPEThread` and the psums are
        int64 sums (adder-net-0 is a plain adder).
        """
        if self.mode == "float":
            return windows.double() @ ws.double().transpose(-1, -2)
        prods = self.thread.batch(
            w_codes[..., None, :, :], window_codes[..., :, None, :],
            w_signs[..., None, :, :],
            a_nonzero=(windows != 0)[..., :, None, :],
            w_nonzero=(ws != 0)[..., None, :, :])     # [..., r, k, dc]
        return prods.sum(dim=-1)


def _adder_net1(o, carry):
    """Adder-net-1 over the psums ``o [bands, ..., 6, 3]`` of consecutive
    bands.  ``carry`` is the shift register's (o40, o50, o51) of the band
    before the first.  Returns the output rows r0-2 .. r0+3 of each band as
    ``[bands * 6, ...]`` and the shift register of the last band.

    Every output row is (o_{r,0} + o_{r+1,1}) + o_{r+2,2}, in that order,
    whether its psums come from one band or through the shift register."""
    s40, s50, s51 = o[..., 4, 0], o[..., 5, 0], o[..., 5, 1]
    p40, p50, p51 = (torch.cat([c[None], s[:-1]])
                     for c, s in zip(carry, (s40, s50, s51)))
    rows = [p40 + p51 + o[..., 0, 2],                        # row r0-2
            p50 + o[..., 0, 1] + o[..., 1, 2]]               # row r0-1
    rows += [o[..., r, 0] + o[..., r + 1, 1] + o[..., r + 2, 2]
             for r in range(PE_ROWS - 2)]                    # rows r0..r0+3
    out = torch.stack(rows, dim=1)
    return out.reshape(-1, *out.shape[2:]), (s40[-1], s50[-1], s51[-1])


class PEGrid:
    """The full 6-matrix grid with adder-net-1 + boundary shift registers."""

    def __init__(self, mode: str = "float",
                 quant_cfg: LogQuantConfig | None = None,
                 out_frac_bits: int = 12, device=None):
        self.device = resolve_device(device)
        self.mode = mode
        self.quant_cfg = quant_cfg or LogQuantConfig(per_channel=False)
        self.thread = LogPEThread(self.quant_cfg.frac_bits, out_frac_bits,
                                  self.device)
        self.matrix = PEMatrix(mode, self.thread)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # -- log-domain helpers (host-side state-controller work) ---------------
    def _codes(self, x):
        """Log quantization of a tensor on the grid's device → (codes int64,
        signs int64, nonzero, scale, dequantized)."""
        # the grid models one ⟨m,n⟩ grid per tensor (paper §3); a per-channel
        # scale would be silently collapsed to channel 0's scale below
        if self.quant_cfg.per_channel:
            raise ValueError("PEGrid log mode needs "
                             "LogQuantConfig(per_channel=False)")
        packed, scale = log_quantize(self._tensor(x), self.quant_cfg)
        code, sign, nz = unpack(packed, self.quant_cfg)
        deq = log_dequantize(packed, scale, self.quant_cfg)
        return (code.to(torch.int64), sign.to(torch.int64), nz,
                float(scale.reshape(-1)[0]), deq)

    def _operands(self, x, w):
        """(x codes, w codes, w signs, psum scale); None codes and signs in
        float mode, where the psums need no scale."""
        if self.mode != "log":
            return None, None, None, 1.0
        xc, _, _, xscale, _ = self._codes(x)
        wc, ws, _, wscale, _ = self._codes(w)
        return xc, wc, ws, xscale * wscale

    def _scaled(self, psums, scale: float):
        """Integer psums → float64, as ``psums / 2^F · xscale · wscale``."""
        if self.mode != "log":
            return psums
        F = float(1 << self.thread.out_frac_bits)
        return psums.double() / F * scale

    # ------------------------------------------------------------------
    def conv2d(self, x, w, stride: int = 1):
        """x: [H, W, C]; w: [3, 3, C, P] (kh, kw, cin, cout). Valid padding.

        Returns (y [H_out, W_out, P] float32, GridStats).  Channels are
        assigned to matrices 6-at-a-time (channel groups), filters iterate
        over passes, psums are channel-accumulated (Fig. 13) before
        adder-net-1.
        """
        x, w = self._tensor(x), self._tensor(w)
        if tuple(w.shape[:2]) != (3, 3):
            raise ValueError("PE grid conv is 3x3")
        return self._conv2d(x, w, stride)

    def _conv2d(self, x, w, stride: int):
        """`conv2d` with every thread of many (band, position, channel
        group, filter) cycles in one `cycle_psums_batch` call.

        The arithmetic is the JAX package's per-cycle loop's: the same
        integer LUT+shift per thread, the same Fig-13 channel accumulation,
        the same adder-net-1 sums and boundary shift registers, the same
        GridStats counts.  Only the float64 sum over channel groups may run
        in another order."""
        H, W, C = x.shape
        P = w.shape[3]
        Ho = (H - 3) // stride + 1
        Wo = (W - 3) // stride + 1
        nb, ng = _cdiv(H, PE_ROWS), _cdiv(C, N_MATRICES)
        xc, wc, ws, scale = self._operands(x, w)
        # zero rows finish the last band and zero channels the last group:
        # a zero operand gates its thread, so neither changes a psum
        pad_x = (0, ng * N_MATRICES - C, 0, 0, 0, nb * PE_ROWS - H)
        pad_w = (0, 0, 0, ng * N_MATRICES - C)

        def windows(t):
            # [band, position j, group, channel, PE row, col dc]
            t = torch.nn.functional.pad(t, pad_x).unfold(1, 3, stride)
            return t.reshape(nb, PE_ROWS, Wo, ng, N_MATRICES, 3) \
                .permute(0, 2, 3, 4, 1, 5)

        def weights(t):
            # [group, channel, filter, k, dc]: matrix (g, c)'s 3x3 block
            return torch.nn.functional.pad(t, pad_w) \
                .reshape(3, 3, ng, N_MATRICES, P).permute(2, 3, 4, 0, 1)

        xw, wm = windows(x), weights(w)
        xcw, wcm, wsm = ((windows(xc), weights(wc), weights(ws))
                         if xc is not None else (None, None, None))
        y = torch.zeros((Ho, Wo, P), dtype=torch.float64, device=self.device)
        per_band = Wo * N_MATRICES * PE_ROWS * PE_COLS * THREADS * 3
        gc = _fit(ng, CHUNK // per_band)
        pc = _fit(P, CHUNK // (per_band * gc))
        bc = _fit(nb, CHUNK // (per_band * gc * pc))
        for p0, p1 in _spans(P, pc):
            for g0, g1 in _spans(ng, gc):
                win = xw[:, :, g0:g1, :, None]
                cw = (xcw[:, :, g0:g1, :, None] if xcw is not None else None)
                wsel = (slice(g0, g1), slice(None), slice(p0, p1))
                carry = (torch.zeros((Wo, g1 - g0, p1 - p0),
                                     dtype=torch.float64,
                                     device=self.device),) * 3
                for b0, b1 in _spans(nb, bc):
                    psums = self.matrix.cycle_psums_batch(
                        win[b0:b1], wm[wsel],
                        window_codes=None if cw is None else cw[b0:b1],
                        w_codes=None if wcm is None else wcm[wsel],
                        w_signs=None if wsm is None else wsm[wsel])
                    # Fig-13 channel accumulation: [band, j, group, P, r, k]
                    o = self._scaled(psums.sum(dim=3), scale)
                    rows, carry = _adder_net1(o, carry)
                    self._add_rows(y[:, :, p0:p1], rows.sum(dim=2),
                                   b0 * PE_ROWS - 2, stride)
        stats = GridStats(
            cycles=P * ng * nb * Wo,
            useful_macs=9 * C * P * Ho * Wo,
            # every band but the last hands its boundary psums to the next
            stored_psums=3 * Wo * P * ng * (nb - 1),
            total_psums=18 * P * ng * nb * Wo,
            active_thread_cycles=PE_ROWS * PE_COLS * THREADS * C * P * nb * Wo)
        return y.to(torch.float32), stats

    @staticmethod
    def _add_rows(y, rows, first: int, stride: int):
        """Add adder-net-1's rows (input-row indices ``first``, ``first+1``,
        ...) into the output rows they land on at ``stride``."""
        Ho = y.shape[0]
        ro = torch.arange(first, first + rows.shape[0], device=y.device)
        keep = (ro >= 0) & (ro % stride == 0) & (ro // stride < Ho)
        y.index_add_(0, ro[keep] // stride, rows[keep])

    # ------------------------------------------------------------------
    def conv2d_depthwise(self, x, w, stride: int = 1):
        """x: [H, W, C]; w: [3, 3, C] (one 3×3 filter per channel). Valid pad.

        MobileNet's dwconv on the grid: each matrix still owns one channel,
        but there is no Fig-13 channel accumulation: matrix c's adder-net-1
        output IS output channel c.  Returns (y [Ho, Wo, C] float32,
        GridStats).
        """
        x, w = self._tensor(x), self._tensor(w)
        if tuple(w.shape) != (3, 3, x.shape[2]):
            raise ValueError(f"depthwise weights {tuple(w.shape)} for "
                             f"{x.shape[2]} channels")
        H, W, C = x.shape
        Ho = (H - 3) // stride + 1
        Wo = (W - 3) // stride + 1
        nb, ng = _cdiv(H, PE_ROWS), _cdiv(C, N_MATRICES)
        xc, wc, ws, scale = self._operands(x, w)
        y = self._depthwise(x, xc, w, wc, ws, scale, stride)
        stats = GridStats(
            cycles=nb * Wo * ng,
            useful_macs=9 * C * Ho * Wo,
            stored_psums=3 * C * Wo * (nb - 1),
            total_psums=18 * nb * Wo * ng,
            active_thread_cycles=PE_ROWS * PE_COLS * THREADS * C * nb * Wo)
        return y.to(torch.float32), stats

    def _depthwise(self, x, xc, w, wc, ws, scale, stride):
        H, W, C = x.shape
        Ho = (H - 3) // stride + 1
        Wo = (W - 3) // stride + 1
        nb = _cdiv(H, PE_ROWS)

        def windows(t):
            # [band, position j, channel, PE row, col dc]
            t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, nb * PE_ROWS - H))
            return t.unfold(1, 3, stride).reshape(nb, PE_ROWS, Wo, C, 3) \
                .permute(0, 2, 3, 1, 4)

        xw, wm = windows(x), w.permute(2, 0, 1)                  # [C, 3, 3]
        xcw = wcm = wsm = None
        if xc is not None:
            xcw = windows(xc)
            wcm, wsm = wc.permute(2, 0, 1), ws.permute(2, 0, 1)
        y = torch.zeros((Ho, Wo, C), dtype=torch.float64, device=self.device)
        per_band = Wo * PE_ROWS * PE_COLS * THREADS
        cc = _fit(C, CHUNK // per_band)
        bc = _fit(nb, CHUNK // (per_band * cc))
        for c0, c1 in _spans(C, cc):
            carry = (torch.zeros((Wo, c1 - c0), dtype=torch.float64,
                                 device=self.device),) * 3
            for b0, b1 in _spans(nb, bc):
                psums = self.matrix.cycle_psums_batch(
                    xw[b0:b1, :, c0:c1], wm[c0:c1],
                    window_codes=None if xcw is None else xcw[b0:b1, :, c0:c1],
                    w_codes=None if wcm is None else wcm[c0:c1],
                    w_signs=None if wsm is None else wsm[c0:c1])
                rows, carry = _adder_net1(self._scaled(psums, scale), carry)
                self._add_rows(y[:, :, c0:c1], rows, b0 * PE_ROWS - 2, stride)
        return y

    # ------------------------------------------------------------------
    def conv2d_1x1(self, x, w):
        """x: [H, W, C]; w: [C, P].  Channel-parallel mapping of §5.2:

        each matrix takes 3 channels (one per thread), 18 pixel slots per
        cycle, channel accumulation across matrices (Fig. 13)."""
        x, w = self._tensor(x), self._tensor(w)
        H, W, C = x.shape
        P = w.shape[1]
        ch_per_group = N_MATRICES * THREADS  # 18 channels in flight
        n_ptiles = _cdiv(H * W, PE_ROWS * PE_COLS)  # 18 pixels/cycle
        xc, wc, ws, scale = self._operands(x, w)
        pix = x.reshape(H * W, C)
        xcf = xc.reshape(H * W, C) if xc is not None else None
        y = self._1x1(pix, xcf, w, wc, ws, scale)
        # a matrix holds 3 channels × 18 pixel slots
        loaded = sum(_cdiv(min(ch_per_group, C - c0), THREADS)
                     for c0 in range(0, C, ch_per_group))
        n_cgroups = _cdiv(C, ch_per_group)
        stats = GridStats(
            cycles=P * n_cgroups * n_ptiles,
            useful_macs=P * C * H * W,
            total_psums=18 * P * n_cgroups * n_ptiles,
            active_thread_cycles=PE_ROWS * PE_COLS * THREADS * P * n_ptiles
            * loaded)
        return y.reshape(H, W, P).to(torch.float32), stats

    def _1x1(self, pix, xcf, w, wc, ws, scale):
        HW, C = pix.shape
        P = w.shape[1]
        G = N_MATRICES * THREADS
        ng = _cdiv(C, G)

        xg = torch.nn.functional.pad(pix, (0, ng * G - C)).reshape(HW, ng, G)
        wg = torch.nn.functional.pad(w, (0, 0, 0, ng * G - C)) \
            .reshape(ng, G, P)
        xcg = wcg = wsg = None
        if xcf is not None:
            xcg = torch.nn.functional.pad(xcf, (0, ng * G - C)) \
                .reshape(HW, ng, G)
            wcg, wsg = (torch.nn.functional.pad(t, (0, 0, 0, ng * G - C))
                        .reshape(ng, G, P) for t in (wc, ws))
        y = torch.zeros((HW, P), dtype=torch.float64, device=self.device)
        gc = _fit(ng, CHUNK // G)
        pc = _fit(P, CHUNK // (G * gc))
        ic = _fit(HW, CHUNK // (G * gc * pc))
        for p0, p1 in _spans(P, pc):
            for g0, g1 in _spans(ng, gc):
                for i0, i1 in _spans(HW, ic):
                    xs = xg[i0:i1, g0:g1, :, None]
                    wsel = wg[None, g0:g1, :, p0:p1]
                    if xcg is None:
                        prods = xs.double() * wsel.double()
                    else:
                        prods = self.thread.batch(
                            wcg[None, g0:g1, :, p0:p1],
                            xcg[i0:i1, g0:g1, :, None],
                            wsg[None, g0:g1, :, p0:p1],
                            a_nonzero=xs != 0, w_nonzero=wsel != 0)
                    # adder nets: the 18 channels of a group, then the groups
                    o = self._scaled(prods.sum(dim=2), scale)
                    y[i0:i1, p0:p1] += o.sum(dim=1)
        return y
