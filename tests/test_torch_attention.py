"""The port's attention (`repro_torch.kernels.ops.attention`) against the JAX
package's.

On the CPU, each route of the port ("cuda", whose wrapper runs the plain
`ref_attention` for a CPU tensor, "blockwise" and "ref") is held against
`flash_attention_pallas(interpret=True)` and JAX's `ref_attention` on the
MHA/GQA/MQA × window sweep of `tests/test_kernels_attention.py`, at its
tolerances (fp32 2e-4, bf16 3e-2), plus decode offsets, the ring
``k_offset`` and per-row offset vectors.  The test marked ``cuda`` holds
the hand-written kernel against its plain versions; it runs only where
there is a card.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the machine with the card has no JAX: only the cuda test runs there
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels.ref import ref_attention as jref
except ImportError:
    jnp = None

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_traffic_bytes, flash_attention_cuda)
from repro_torch.kernels.ref import ref_attention  # noqa: E402

ROUTES = ("cuda", "blockwise", "ref")
TOL = {"float32": 2e-4, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def _reference_package(request):
    if jnp is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs jax: the JAX package is the reference")


def _mk(b, tq, tk, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, tq, h, d), (b, tk, hkv, d), (b, tk, hkv, d)))


def _port(arrays, dtype="float32"):
    return tuple(torch.from_numpy(a).to(getattr(torch, dtype))
                 for a in arrays)


def _jax(arrays, dtype="float32"):
    return tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)


def _check(got, want, tol, msg):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _all_routes(qkv, want: dict, tol, cfg=None, **kw):
    for impl in ROUTES:
        got = tops.attention(*qkv, impl=impl, config=cfg, **kw)
        assert got.dtype == qkv[0].dtype and got.shape == qkv[0].shape
        for name, y in want.items():
            _check(got, y, tol, f"{impl} vs JAX {name}")


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("hkv", [1, 2, 8])   # MQA, H/4 GQA, MHA (H = 8)
def test_gqa_sweep_matches_jax(hkv, window):
    arrays = _mk(1, 48, 48, 8, hkv, 16, seed=7)
    qj = _jax(arrays)
    want = {"pallas": jops.attention(*qj, causal=True, window=window,
                                     impl="pallas", interpret=True,
                                     config=jops.AttentionConfig(
                                         block_q=16, block_k=16)),
            "ref": jref(*qj, causal=True, window=window)}
    _all_routes(_port(arrays), want, TOL["float32"],
                cfg=tops.AttentionConfig(block_k=16), causal=True,
                window=window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,hkv,d,window", [
    (2, 40, 8, 2, 64, None),      # GQA
    (1, 33, 4, 1, 64, 8),         # MQA + sliding window, ragged T
])
def test_dtype_sweep_matches_jax(b, t, h, hkv, d, window, dtype):
    arrays = _mk(b, t, t, h, hkv, d, seed=1)
    qj = _jax(arrays, dtype)
    want = {"pallas": jops.attention(*qj, causal=True, window=window,
                                     impl="pallas", interpret=True),
            "ref": jref(*qj, causal=True, window=window)}
    _all_routes(_port(arrays, dtype), want, TOL[dtype],
                cfg=tops.AttentionConfig(block_k=16), causal=True,
                window=window)


@pytest.mark.parametrize("hkv", [1, 8])
def test_decode_offset_matches_jax(hkv):
    """One query row at q_offset = Tk - 1, as an int and as a tensor [B],
    against JAX's Pallas kernel with a traced offset and the full-prefill
    row of its oracle."""
    h, t, d = 8, 64, 16
    arrays = _mk(1, t, t, h, hkv, d, seed=8)
    qj = _jax(arrays)
    full = jref(*qj, causal=True)[:, -1:]
    cfg = jops.AttentionConfig(block_q=8, block_k=16)
    pallas = jax.jit(lambda q, k, v, off: jops.attention(
        q, k, v, causal=True, q_offset=off, impl="pallas", interpret=True,
        config=cfg))(qj[0][:, -1:], qj[1], qj[2], jnp.asarray(t - 1))
    q, k, v = _port(arrays)
    for off in (t - 1, torch.tensor([t - 1])):
        _all_routes((q[:, -1:], k, v), {"pallas": pallas, "ref": full},
                    TOL["float32"], cfg=tops.AttentionConfig(block_k=16),
                    causal=True, q_offset=off)


def test_ring_k_offset_matches_jax():
    """k[0] at absolute position -9: the first 9 slots were never written
    and are masked (`test_kernels_attention.py:81`)."""
    arrays = _mk(1, 1, 32, 4, 2, 16, seed=9)
    kw = dict(causal=True, window=8, q_offset=22, k_offset=-9)
    qj = _jax(arrays)
    want = {"pallas": jops.attention(
                *qj, impl="pallas", interpret=True,
                config=jops.AttentionConfig(block_q=8, block_k=8), **kw),
            "ref": jref(*qj, **kw)}
    _all_routes(_port(arrays), want, TOL["float32"],
                cfg=tops.AttentionConfig(block_k=8), **kw)


def test_per_row_offsets_match_jax_row_by_row():
    """A [B] offset vector (the engine's batched decode) equals JAX called
    on each row with its own scalar offsets, ring offsets included."""
    B, S = 3, 32
    arrays = _mk(B, 1, S, 4, 1, 16, seed=10)
    q_off = np.array([5, 20, 40])
    k_off = q_off - S + 1
    cfg = jops.AttentionConfig(block_q=8, block_k=8)
    for window, ko in ((None, 0), (16, k_off)):
        rows = []
        for b in range(B):
            qj = _jax([a[b:b + 1] for a in arrays])
            kob = 0 if window is None else int(ko[b])
            rows.append(np.asarray(jops.attention(
                *qj, causal=True, window=window, q_offset=int(q_off[b]),
                k_offset=kob, impl="pallas", interpret=True, config=cfg)))
        _all_routes(_port(arrays), {"pallas": np.concatenate(rows)},
                    TOL["float32"], cfg=tops.AttentionConfig(block_k=8),
                    causal=True, window=window,
                    q_offset=torch.from_numpy(q_off),
                    k_offset=ko if window is None else torch.from_numpy(ko))


def test_gqa_broadcast_and_bf16_accumulation_match_jax():
    arrays = _mk(1, 32, 32, 4, 2, 16, seed=3)
    for acc in ("float32", "bfloat16"):
        want = jops.attention(*_jax(arrays), impl="blockwise",
                              config=jops.AttentionConfig(
                                  block_k=8, gqa_broadcast=True,
                                  acc_dtype=getattr(jnp, acc)))
        got = tops.attention(*_port(arrays), impl="blockwise",
                             config=tops.AttentionConfig(
                                 block_k=8, gqa_broadcast=True,
                                 acc_dtype=getattr(torch, acc)))
        _check(got, want, TOL[acc], acc)


def test_head_mismatch_raises_clear_valueerror():
    q, k, v = _port(_mk(1, 8, 8, 6, 4, 16))
    with pytest.raises(ValueError, match="H=6 query heads vs Hkv=4"):
        tops.attention(q, k, v)
    with pytest.raises(ValueError, match="inconsistent attention operands"):
        tops.attention(q, k[:, :4], v)
    with pytest.raises(ValueError, match="H=6 query heads vs Hkv=4"):
        flash_attention_cuda(q, k, v)


def test_legacy_kwargs_deprecated_but_equivalent():
    q, k, v = _port(_mk(1, 32, 32, 4, 2, 16, seed=3))
    with pytest.warns(DeprecationWarning, match="AttentionConfig"):
        old = tops.attention(q, k, v, impl="blockwise", block_k=8,
                             gqa_broadcast=True)
    new = tops.attention(q, k, v, impl="blockwise",
                         config=tops.AttentionConfig(block_k=8,
                                                     gqa_broadcast=True))
    assert torch.equal(old, new)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="not both"):
            tops.attention(q, k, v, impl="blockwise", block_k=8,
                           config=tops.AttentionConfig(block_k=8))


def test_resolve_impl_precedence():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    # the tensors' device decides "auto"; no card is needed to resolve it
    for op in ("log_matmul", "conv2d", "attention"):
        assert tops.resolve_impl(op) == "blockwise"
        assert tops.resolve_impl(op, "auto", cpu) == "blockwise"
        assert tops.resolve_impl(op, "auto", cuda) == "cuda"
        assert tops.resolve_impl(op, "ref", cuda) == "ref"
        assert tops.resolve_impl(op, "cuda", cpu) == "cuda"
        with pytest.raises(ValueError, match="unknown"):
            tops.resolve_impl(op, "nope")
        with pytest.raises(ValueError, match="unknown"):
            tops.resolve_impl(op, "pallas")


def test_traffic_model_matches_jax():
    """The byte model of each route; the GQA-native kernel's K/V term
    scales with Hkv, as the TPU kernel's does."""
    from repro.kernels.flash_attention import attention_traffic_bytes as jtb
    for impl, jimpl in (("cuda", "pallas"), ("repeat", "repeat"),
                        ("blockwise", "blockwise"), ("ref", "ref")):
        args = (2, 64, 4096, 8, 2, 128)
        assert attention_traffic_bytes(impl, *args, block_q=16,
                                       block_k=32) == \
            jtb(jimpl, *args, block_q=16, block_k=32)
    gqa = attention_traffic_bytes("cuda", 1, 1, 4096, 8, 2, 128)
    mha = attention_traffic_bytes("cuda", 1, 1, 4096, 8, 8, 128)
    assert mha["kv"] == 4 * gqa["kv"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_versions(cuda_device):
    """The hand-written kernel against `ref_attention` and the blockwise
    version on the card: the GQA × window sweep, per-row decode offsets,
    the ring offset and a bf16 q over an fp32 cache."""
    dev = cuda_device
    cases = []
    for hkv in (1, 2, 8):
        for window in (None, 16):
            cases.append((_mk(1, 48, 48, 8, hkv, 16, seed=7),
                          dict(window=window), "float32", "float32"))
    offs = torch.tensor([5, 20, 31], device=dev)
    cases += [
        (_mk(3, 1, 32, 8, 1, 256, seed=2), dict(q_offset=offs), "bfloat16",
         "float32"),
        (_mk(1, 1, 32, 4, 2, 16, seed=9),
         dict(window=8, q_offset=22, k_offset=-9), "float32", "float32"),
        (_mk(1, 33, 33, 8, 1, 256, seed=4), {}, "bfloat16", "bfloat16"),
    ]
    for (q, k, v), kw, qdt, kvdt in cases:
        q = torch.from_numpy(q).to(dev, getattr(torch, qdt))
        k, v = (torch.from_numpy(a).to(dev, getattr(torch, kvdt))
                for a in (k, v))
        want = ref_attention(q, k, v, causal=True, **kw)
        bw = tops.attention(q, k, v, causal=True, impl="blockwise",
                            config=tops.AttentionConfig(block_k=16), **kw)
        before = flash_attention_cuda.launches
        got = flash_attention_cuda(q, k, v, causal=True, **kw)
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches == before + 1
        assert got.dtype == q.dtype and got.shape == q.shape
        rel = 2e-4 if qdt == "float32" else 8e-3
        tol = rel * (float(want.float().abs().max()) + 1)
        for y in (want, bw):
            assert float((got.float() - y.float()).abs().max()) <= tol
