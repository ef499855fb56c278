"""The port's attention (`repro_torch.kernels.ops.attention`) against the JAX
package's.

On the CPU, each route of the port ("cuda", whose wrapper runs the plain
`ref_attention` for a CPU tensor, "blockwise" and "ref") is held against
`flash_attention_pallas(interpret=True)` and JAX's `ref_attention` on the
MHA/GQA/MQA × window sweep of `tests/test_kernels_attention.py`, at its
tolerances (fp32 2e-4, bf16 3e-2), plus decode offsets, the ring
``k_offset`` and per-row offset vectors.  The kernel's launch shape
(`flash_attention_geometry`) is checked at gemma-2b's shapes, and the plain
model of its split-KV variant (`split_kv_attention`: per-split partials,
then the combine) is held against the TPU kernel over split counts and
masks, empty splits and a row masked everywhere included.  The test marked
``cuda`` holds the hand-written kernel against its plain versions; it runs
only where there is a card.
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
    MAX_SPLITS, MIN_SPLIT_KEYS, MMA_ROWS, NEG_INF, SPLIT_KEYS, SPLIT_ROWS,
    attention_traffic_bytes, flash_attention_cuda, flash_attention_geometry,
    mma_error_limit, split_kv_attention, split_kv_partials)
from repro_torch.kernels.ref import attention_mask, ref_attention  # noqa: E402

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


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,D,qdt,kvdt,variant,blocks", [
    (4, 1, 64, 8, 1, 256, BF16, F32, "split", 4),     # gemma-2b decode step
    (4, 1, 8192, 8, 1, 256, BF16, F32, "split", 128),
    (4, 1, 8192, 8, 1, 256, F32, F32, "split", 128),
    (1, 4, 4, 8, 1, 256, BF16, BF16, "mma", 1),       # prefill buckets
    (1, 8, 8, 8, 1, 256, BF16, BF16, "mma", 1),
    (1, 16, 16, 8, 1, 256, BF16, BF16, "mma", 2),
    (1, 2048, 2048, 8, 1, 256, BF16, BF16, "mma", 256),
    (1, 2048, 2048, 8, 1, 256, F32, F32, "split", 2048),
    (2, 1, 300, 4, 4, 64, F32, F32, "split", 32),     # MHA, reduced
    (4, 1, 8191, 8, 1, 256, BF16, F32, "split", 128),  # ragged Tk
    (4, 1, 8193, 8, 1, 256, BF16, F32, "split", 132),
    (3, 1, 1000, 8, 1, 256, BF16, F32, "split", 33),
])
def test_geometry_at_gemma_shapes(B, Tq, Tk, H, Hkv, D, qdt, kvdt, variant,
                                  blocks):
    """The variant, the blocks of a launch on 132 SMs, and splits that
    cover every key exactly once with none empty."""
    n_sm = 132
    geo = flash_attention_geometry(B, Tq, Tk, H, Hkv, D, qdt, kvdt, n_sm)
    assert geo["variant"] == variant and geo["blocks"] == blocks
    assert geo["rows"] == (MMA_ROWS if variant == "mma" else SPLIT_ROWS)
    assert geo["row_blocks"] == -(-H // Hkv * Tq // geo["rows"])
    tiles = B * Hkv * geo["row_blocks"]
    kps, splits = geo["keys_per_split"], geo["splits"]
    assert geo["blocks"] == tiles * splits
    owner = [j // kps for j in range(Tk)]
    assert sorted(set(owner)) == list(range(splits))  # each split has keys
    if variant == "mma":
        assert splits == 1
    else:
        assert kps % SPLIT_KEYS == 0 and splits <= MAX_SPLITS
        assert splits == 1 or kps >= MIN_SPLIT_KEYS
        if tiles < n_sm and Tk >= MIN_SPLIT_KEYS * -(-n_sm // tiles):
            assert 0.9 * n_sm <= geo["blocks"] <= 2 * n_sm  # about a wave
    # an unaligned row or an odd head_dim never takes the tensor cores
    assert flash_attention_geometry(B, Tq, Tk, H, Hkv, D, qdt, kvdt, n_sm,
                                    aligned=False)["variant"] == "split"
    assert flash_attention_geometry(B, Tq, Tk, H, Hkv, 40, qdt, kvdt,
                                    n_sm)["variant"] == "split"


SPLIT_MASKS = {
    "causal": dict(causal=True, q_offset=36),
    "noncausal": dict(causal=False),
    "window": dict(causal=True, window=12, q_offset=36),
    "ring": dict(causal=True, window=16, q_offset=30, k_offset=-9),
    "per_row": dict(causal=True, q_offset=np.array([36, 20]),
                    k_offset=np.array([0, -5])),
}
_PALLAS_SPLIT: dict = {}


def _pallas_rows(arrays, kw, block=8):
    """`flash_attention_pallas(interpret=True)` on each batch row with its
    own scalar offsets."""
    cfg = jops.AttentionConfig(block_q=block, block_k=block)
    rows = []
    for b in range(arrays[0].shape[0]):
        kb = {n: (int(v_[b]) if isinstance(v_, np.ndarray) else v_)
              for n, v_ in kw.items()}
        rows.append(np.asarray(jops.attention(
            *_jax([a[b:b + 1] for a in arrays]), impl="pallas",
            interpret=True, config=cfg, **kb)))
    return np.concatenate(rows)


def _torch_kw(kw):
    return {n: (torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_)
            for n, v_ in kw.items()}


@pytest.mark.parametrize("mask", sorted(SPLIT_MASKS))
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_split_kv_model_matches_jax(splits, mask):
    """The split-KV variant's split and combine, in plain torch, against the
    TPU kernel and `ref_attention`: GQA rows folded, 1 to 7 splits, causal,
    non-causal, windowed (the first splits empty), a ring ``k_offset`` and
    per-row offsets."""
    arrays = _mk(2, 4, 40, 4, 2, 16, seed=11)
    kw = SPLIT_MASKS[mask]
    if mask not in _PALLAS_SPLIT:
        _PALLAS_SPLIT[mask] = _pallas_rows(arrays, kw)
    q, k, v = _port(arrays)
    got = split_kv_attention(q, k, v, keys_per_split=-(-40 // splits),
                             **_torch_kw(kw))
    assert got.shape == q.shape and got.dtype == q.dtype
    _check(got, _PALLAS_SPLIT[mask], TOL["float32"], "vs pallas")
    _check(got, ref_attention(q, k, v, **_torch_kw(kw)), TOL["float32"],
           "vs ref_attention")


def test_split_kv_empty_splits_and_a_masked_row():
    """Row 0 sees 6 keys (a window), so its first splits are empty; row 1
    sees none (every key at a position < 0).  An empty split's partials are
    exactly (NEG_INF, 0, 0) and add nothing; the masked row gives 0, as the
    TPU kernel's ``l → 1`` guard does."""
    arrays = _mk(2, 1, 32, 4, 1, 16, seed=12)
    kw = dict(causal=True, window=6, q_offset=np.array([31, 10]),
              k_offset=np.array([0, -40]))
    q, k, v = _port(arrays)
    m, l, acc = split_kv_partials(q, k, v, keys_per_split=8,
                                  **_torch_kw(kw))
    assert m.shape == (4, 2, 1, 4) and acc.shape == (4, 2, 1, 4, 16)
    empty = torch.zeros(4, 2, dtype=torch.bool)
    empty[:3, 0] = True                        # keys 26..31 are in split 3
    empty[:, 1] = True
    assert bool((m[empty] == NEG_INF).all()) and bool((l[empty] == 0).all())
    assert bool((acc[empty] == 0).all())
    assert bool((l[3, 0] > 0).all())
    got = split_kv_attention(q, k, v, keys_per_split=8, **_torch_kw(kw))
    assert bool(torch.isfinite(got).all())
    assert bool((got[1] == 0).all())
    _check(got, _pallas_rows(arrays, kw), TOL["float32"], "vs pallas")
    one = split_kv_attention(q[:1], k[:1], v[:1], keys_per_split=32,
                             causal=True, window=6, q_offset=31)
    assert torch.equal(got[:1], one) or float(
        (got[:1] - one).abs().max()) <= 1e-6


def test_traffic_model_describes_the_kernel_tiles():
    """Without explicit blocks, the cuda bytes follow the kernel: split-KV
    at decode reads K/V once (one row block of 8) and moves its 32 splits'
    partials twice; the tensor-core prefill re-reads K/V once per block of
    64 folded rows."""
    kv = 2 * 4 * 8192 * 256 * 4
    t = attention_traffic_bytes("cuda", 4, 1, 8192, 8, 1, 256)
    assert t["kv"] == kv
    assert t["total"] == kv + 2 * 4 * 8 * 256 * 4 \
        + 2 * 4 * 32 * 4 * SPLIT_ROWS * 258
    t = attention_traffic_bytes("cuda", 1, 2048, 2048, 8, 1, 256, itemsize=2)
    assert t["kv"] == 2 * 2048 * 256 * 2 * (8 * 2048 // MMA_ROWS)
    assert t["total"] == t["kv"] + 2 * 2048 * 8 * 256 * 2
    # one split, one row block: K/V exactly once
    t = attention_traffic_bytes("cuda", 4, 1, 64, 8, 1, 256)
    assert t["kv"] == 2 * 4 * 64 * 256 * 4


def test_offsets_reach_the_kernel_as_values_or_pointers():
    """An int offset is passed by value; an int tensor with one value or one
    per batch row is read in place (its pointer, kind 1 for int32 and 2 for
    int64, element b * step), so a decode step builds no offset tensor."""
    from repro_torch.kernels.flash_attention import _offset_arg
    cpu = torch.device("cpu")
    assert _offset_arg(7, 4, cpu) == (None, 7, 0, 0)
    rows = torch.tensor([5, 9, 2, 0], dtype=torch.int32)
    t, _, kind, step = _offset_arg(rows, 4, cpu)
    assert t.data_ptr() == rows.data_ptr() and (kind, step) == (1, 1)
    one = torch.tensor(12)
    t, _, kind, step = _offset_arg(one.reshape(-1).expand(4), 4, cpu)
    assert t.data_ptr() == one.data_ptr() and (kind, step) == (2, 0)
    t, _, kind, step = _offset_arg(torch.tensor([3, 4], dtype=torch.int16),
                                   2, cpu)
    assert t.dtype == torch.int64 and t.tolist() == [3, 4] and kind == 2
    with pytest.raises(ValueError, match="one per batch row"):
        _offset_arg(rows, 3, cpu)
    with pytest.raises(ValueError, match="outside int32"):
        _offset_arg(2 ** 31, 1, cpu)


def _mma_arithmetic(q, k, v, *, tile, drop_tile=None, causal=True,
                    window=None, q_offset=0, k_offset=0):
    """The tensor-core variant's arithmetic in plain torch, one key tile at
    a time: S in fp32 from bf16 operands, a running max, p = exp(s - m)
    rounded to bf16 for PV while l sums it unrounded, o rounded to bf16.
    ``drop_tile`` leaves one key tile out, a fault the limit must catch."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    f32 = torch.float32
    qf = q.to(f32).permute(0, 2, 1, 3)
    kf, vf = (t.to(f32).repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
              for t in (k, v))
    mask = attention_mask(Tq, Tk, causal=causal, window=window,
                          q_offset=q_offset, k_offset=k_offset,
                          device=q.device)[:, None]
    neg = torch.tensor(NEG_INF)
    m = torch.full((B, H, Tq, 1), NEG_INF)
    l = torch.zeros((B, H, Tq, 1))
    acc = torch.zeros((B, H, Tq, D))
    for t0 in range(0, Tk, tile):
        if t0 // tile == drop_tile:
            continue
        ok = mask[..., t0:t0 + tile]
        s = torch.where(ok, qf @ kf[:, :, t0:t0 + tile].transpose(-1, -2)
                        / D ** 0.5, neg)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + p.to(torch.bfloat16).to(f32) \
            @ vf[:, :, t0:t0 + tile]
        m = m_new
    o = acc / torch.where(l > 0, l, torch.ones(()))
    return o.permute(0, 2, 1, 3).to(torch.bfloat16)


MMA_MASKS = {
    "causal": dict(),
    "window": dict(window=96),
    "per_row": dict(q_offset=np.array([0, 40]), k_offset=np.array([0, -60])),
}


@pytest.mark.parametrize("mask", sorted(MMA_MASKS))
def test_mma_error_limit_holds_the_tensor_core_arithmetic(mask):
    """`mma_error_limit` bounds the tensor-core variant's error from its
    arithmetic alone: a plain emulation of it (bf16 p for PV, online
    softmax over 64-key tiles) stays inside the limit at every element, its
    fp32 attention matches JAX's on the widened operands, and dropping one
    late key tile breaks the limit."""
    arrays = _mk(2, 384, 384, 4, 1, 64, seed=21)
    kw = _torch_kw(MMA_MASKS[mask])
    q, k, v = _port(arrays, "bfloat16")
    o, limit = mma_error_limit(q, k, v, causal=True, **kw)
    assert o.shape == limit.shape == q.shape and o.dtype == torch.float32
    wide = tuple(t.to(torch.float32).numpy() for t in (q, k, v))
    want = _pallas_rows(wide, dict(causal=True, **MMA_MASKS[mask]), block=64)
    _check(o, want, TOL["float32"], "vs pallas")
    dead = ~attention_mask(384, 384, causal=True, device=q.device,
                           window=kw.get("window"),
                           q_offset=kw.get("q_offset", 0),
                           k_offset=kw.get("k_offset", 0)).any(dim=-1)
    assert bool((o[dead.expand(2, 384)] == 0).all())
    assert bool((limit[dead.expand(2, 384)] == 0).all())
    got = _mma_arithmetic(q, k, v, tile=64, **kw)
    err = (got.to(torch.float32) - o).abs()
    assert bool((err <= limit).all()), float((err / limit).nan_to_num().max())
    # on late rows the limit is a fraction of the global 8e-3·(max|o| + 1)
    assert float(limit[:, 300:].mean()) < 0.25 * 8e-3 * (
        float(o.abs().max()) + 1)
    bad = _mma_arithmetic(q, k, v, tile=64, drop_tile=4, **kw)
    assert bool(((bad.to(torch.float32) - o).abs() > limit).any())


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a view one element into a wider buffer: unit stride along
    head_dim, rows that do not start on 16-byte boundaries."""
    wide = torch.zeros((*t.shape[:-1], t.shape[-1] + 1), dtype=t.dtype,
                       device=t.device)
    wide[..., 1:] = t
    return wide[..., 1:]


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
    the ring offset, a bf16 q over an fp32 cache, decode keys on either
    side of a split boundary of the split-KV variant, splits emptied by a
    window or by keys at positions < 0, bf16 prefill at ragged T on the
    tensor cores, the split variant's four dtype pairs, and k and v rows
    off 16-byte boundaries.  Every case gives the same bits over two calls,
    and every tensor-core case stays within `mma_error_limit`."""
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
        (_mk(1, 130, 130, 8, 1, 256, seed=5), {}, "bfloat16", "bfloat16"),
        (_mk(2, 33, 33, 4, 2, 64, seed=6), dict(window=8), "bfloat16",
         "bfloat16"),
    ]
    # a split boundary at B = 4: Tk = 4096 is 32 splits of 128 keys, one
    # more key adds a split
    for tk in (4096, 4097):
        for qdt in ("float32", "bfloat16"):
            cases.append((_mk(4, 1, tk, 8, 1, 256, seed=tk), dict(
                q_offset=torch.tensor([tk - 1, tk - 2, 700, 0], device=dev)),
                qdt, "float32"))
    cases += [
        (_mk(2, 1, 1000, 8, 1, 256, seed=13), dict(window=100, q_offset=999),
         "float32", "float32"),
        (_mk(2, 1, 700, 8, 1, 256, seed=14), dict(
            q_offset=199, k_offset=-500), "bfloat16", "float32"),
        # the split variant's other dtype pairs: bf16 decode over a bf16
        # cache, an fp32 q over bf16 keys, bf16 prefill at a head_dim the
        # tensor cores do not take
        (_mk(4, 1, 64, 8, 1, 256, seed=15), dict(q_offset=torch.tensor(
            [63, 40, 17, 5], device=dev)), "bfloat16", "bfloat16"),
        (_mk(4, 1, 64, 8, 1, 256, seed=16), dict(q_offset=torch.tensor(
            [63, 40, 17, 5], device=dev)), "float32", "bfloat16"),
        (_mk(2, 40, 40, 8, 2, 40, seed=17), dict(window=16), "bfloat16",
         "bfloat16"),
        # the tensor cores' heaviest-first row blocks (T a multiple of 64)
        # under a window, where outputs are O(0.1)
        (_mk(1, 512, 512, 8, 1, 256, seed=18), dict(window=80), "bfloat16",
         "bfloat16"),
    ]
    # k and v rows off 16-byte boundaries: element copies instead of
    # cp.async, for either kv dtype and for bf16 prefill
    cases += [
        (_mk(2, 1, 300, 8, 1, 256, seed=19), dict(q_offset=299), "bfloat16",
         "float32", "unaligned"),
        (_mk(2, 1, 300, 8, 1, 256, seed=20), dict(q_offset=299), "float32",
         "bfloat16", "unaligned"),
        (_mk(1, 48, 48, 8, 2, 64, seed=22), {}, "bfloat16", "bfloat16",
         "unaligned"),
    ]
    for (q, k, v), kw, qdt, kvdt, *layout in cases:
        q = torch.from_numpy(q).to(dev, getattr(torch, qdt))
        k, v = (torch.from_numpy(a).to(dev, getattr(torch, kvdt))
                for a in (k, v))
        if layout:
            k, v = (_unaligned(a) for a in (k, v))
        geo = flash_attention_geometry(*q.shape[:2], k.shape[1], q.shape[2],
                                       *k.shape[2:], q.dtype, k.dtype,
                                       aligned=not layout)
        want = ref_attention(q, k, v, causal=True, **kw)
        bw = tops.attention(q, k, v, causal=True, impl="blockwise",
                            config=tops.AttentionConfig(block_k=16), **kw)
        before = flash_attention_cuda.launches
        got = flash_attention_cuda(q, k, v, causal=True, **kw)
        again = flash_attention_cuda(q, k, v, causal=True, **kw)
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches == before + 2
        assert got.dtype == q.dtype and got.shape == q.shape
        assert torch.equal(got.view(torch.int16), again.view(torch.int16))
        rel = 2e-4 if qdt == "float32" else 8e-3
        tol = rel * (float(want.float().abs().max()) + 1)
        for y in (want, bw):
            assert float((got.float() - y.float()).abs().max()) <= tol
        if geo["variant"] == "mma":
            o, limit = mma_error_limit(q, k, v, causal=True, **kw)
            assert bool(((got.float() - o).abs() <= limit).all())
