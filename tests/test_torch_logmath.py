"""The port's log-PE thread (`repro_torch.core.logmath`) against the JAX
package's (`repro.core.logmath`): the LUT and eq. (8)'s LUT+shift bit for
bit, over every code pair and sign."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)

from repro.core import logmath as jlm  # noqa: E402
from repro_torch.core import logmath as tlm  # noqa: E402

BITS = [(1, 12), (1, 16), (2, 12), (2, 16)]
CODES = np.arange(-64, 32)   # every ⟨6,n⟩ code, the zero code, and g > 0


@pytest.mark.parametrize("frac_bits,out_frac_bits", BITS)
def test_lut_matches_jax(frac_bits, out_frac_bits):
    lut = tlm.make_frac_lut(frac_bits, out_frac_bits, device="cpu")
    assert lut.dtype == torch.int64
    np.testing.assert_array_equal(
        lut.numpy(), jlm.make_frac_lut(frac_bits, out_frac_bits))


@pytest.mark.parametrize("frac_bits,out_frac_bits", BITS)
def test_batch_matches_jax_over_every_code_pair(frac_bits, out_frac_bits):
    """Every (w code, a code, w sign) pair, with both gates, through the
    batched LUT+shift of both packages: equal bit for bit, and equal to the
    port's scalar thread wherever the product fits int64."""
    w, a, s = (m.ravel() for m in np.meshgrid(CODES, CODES, [-1, 1],
                                               indexing="ij"))
    rng = np.random.default_rng(0)
    a_nz, w_nz = rng.random(w.size) < 0.9, rng.random(w.size) < 0.9
    want = jlm.log_product_fixed_batch(w, a, s, a_nz, w_nz, frac_bits,
                                       out_frac_bits)
    got = tlm.log_product_fixed_batch(
        torch.from_numpy(w), torch.from_numpy(a), torch.from_numpy(s),
        torch.from_numpy(a_nz), torch.from_numpy(w_nz), frac_bits,
        out_frac_bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    th = tlm.LogPEThread(frac_bits, out_frac_bits, device="cpu")
    np.testing.assert_array_equal(
        th.batch(torch.from_numpy(w), torch.from_numpy(a),
                 torch.from_numpy(s), torch.from_numpy(a_nz),
                 torch.from_numpy(w_nz)).numpy(), want)
    # the scalar thread on Python ints: where INT(g) leaves room in int64
    fits = (w + a) >> frac_bits <= 62 - (out_frac_bits + 1)
    for i in np.flatnonzero(fits)[::7]:
        v = th(int(w[i]), int(a[i]), int(s[i]), bool(a_nz[i]), bool(w_nz[i]))
        assert v == want[i]


@pytest.mark.parametrize("frac_bits,out_frac_bits", BITS)
def test_scalar_product_matches_jax(frac_bits, out_frac_bits):
    for w, a, s in itertools.product(range(-70, 40, 3), range(-70, 40, 5),
                                     (-1, 1)):
        assert tlm.log_product_fixed(w, a, s, frac_bits, out_frac_bits) == \
            jlm.log_product_fixed(w, a, s, frac_bits, out_frac_bits)


def test_thread_gates_closed_form_and_base2():
    """`test_logmath.py`'s gating and base-2 cases, mirrored, and the
    closed form of eq. (5)."""
    th, jth = tlm.LogPEThread(device="cpu"), jlm.LogPEThread()
    assert th(5, 3, 1, a_nonzero=False) == 0
    assert th(5, 3, 1, w_nonzero=False) == 0
    assert th.closed_form(-3, -2, -1) == jth.closed_form(-3, -2, -1)
    assert th.to_float(th(-3, -2, -1)) == jth.to_float(jth(-3, -2, -1))
    b2 = tlm.LogPEThread(frac_bits=0, out_frac_bits=8, device="cpu")
    assert b2(3, 2, 1) == (1 << 8) << 5
    assert b2(-3, 1, -1) == -((1 << 8) >> 2)


def test_shift_counts_are_clipped():
    """Exponents far below -64 (a shift by 64 or more is undefined) give 0,
    as the JAX package's clip to 62 does."""
    w = torch.tensor([-200, -130, -126, -124])
    got = tlm.log_product_fixed_batch(w, torch.zeros_like(w), 1,
                                      frac_bits=1, out_frac_bits=16)
    np.testing.assert_array_equal(
        got.numpy(), jlm.log_product_fixed_batch(w.numpy(), 0, 1,
                                                 frac_bits=1,
                                                 out_frac_bits=16))
    assert got.tolist() == [0, 0, 0, 0]
