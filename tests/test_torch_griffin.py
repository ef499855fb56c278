"""The port's RG-LRU block (`repro_torch.models.griffin`) against the JAX
package's `repro.models.griffin`, on the same inputs and weights.

The config is recurrentgemma-2b `reduced()` (d 64, LRU width 64, conv
width 4, fp32 activations).  Everything agrees within 1e-5·(max|y|+1):
the causal conv with and without a carried window, the RG-LRU scan with and
without a carried state (also where ``a`` underflows to 0), and the mixer
in one shot and as a prefill followed by decode steps, with its state
written in place.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import griffin as jg  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.models import griffin as tg  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCH = "recurrentgemma-2b"
REL = 1e-5


def _close(got, want, rel=REL, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), want,
                               rtol=rel, atol=rel * (np.abs(want).max() + 1),
                               err_msg=msg)


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _params(seed=0, lam=None):
    """JAX's Griffin init for the reduced config, and the same weights in
    the port (``lam`` overrides Λ)."""
    jp = jg.griffin_init(jax.random.PRNGKey(seed), jget(ARCH).reduced())
    if lam is not None:
        jp = dict(jp, lam=jnp.full_like(jp["lam"], lam))
    return jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def test_init_and_state_match_jax():
    """Leaf names, shapes and the constant leaves (Λ = 2, conv bias 0) as in
    JAX, also with a stacked ``lead``; the state is fp32 h [B, W] and conv
    [B, K−1, W]."""
    cfg_j, cfg_t = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp = jg.griffin_init(jax.random.PRNGKey(0), cfg_j)
    gen = torch.Generator().manual_seed(0)
    tp = tg.griffin_init(gen, cfg_t, lead=(3,), device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: (3,) + v.shape for k, v in jp.items()}
    assert bool((tp["lam"] == 2.0).all()) and bool((tp["conv_b"] == 0).all())
    js = jg.griffin_state_init(cfg_j, 2)
    ts = tg.griffin_state_init(cfg_t, 2, lead=(3,), device="cpu")
    for name in ("h", "conv"):
        assert tuple(ts[name].shape) == (3,) + js[name].shape
        assert ts[name].dtype == torch.float32


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv1d_matches_jax(carried):
    x, w, b = _x(1, 2, 7, 64), _x(2, 4, 64) * 0.3, _x(3, 64)
    prev = _x(4, 2, 3, 64) if carried else None
    yj, cj = jg._causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               None if prev is None else jnp.asarray(prev))
    yt, ct = tg._causal_conv1d(_t(x), _t(w), _t(b),
                               None if prev is None else _t(prev))
    _close(yt, yj)
    _close(ct, cj, rel=0)


@pytest.mark.parametrize("T", [1, 5, 16, 37])
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_matches_jax(T, carried):
    x = _x(5, 2, T, 64)
    loga = -np.abs(_x(6, 2, T, 64)) * 3
    h0 = _x(7, 2, 64) if carried else None
    hj = jg._rglru(jnp.asarray(x), jnp.asarray(loga),
                   None if h0 is None else jnp.asarray(h0))
    ht = tg._rglru(_t(x), _t(loga), None if h0 is None else _t(h0))
    assert ht.dtype == torch.float32
    _close(ht, hj)


def test_rglru_where_a_underflows():
    """log a down to −400: exp underflows to 0 (and a² long before), so
    sqrt(max(1 − a², 1e-12)) = 1 and the state is forgotten; both packages
    stay finite and agree."""
    x = _x(8, 2, 12, 64)
    loga = -np.abs(_x(9, 2, 12, 64)) * 400
    h0 = _x(10, 2, 64)
    hj = jg._rglru(jnp.asarray(x), jnp.asarray(loga), jnp.asarray(h0))
    ht = tg._rglru(_t(x), _t(loga), _t(h0))
    assert bool(torch.isfinite(ht).all())
    assert float((torch.exp(_t(loga)) == 0).float().mean()) > 0.5
    _close(ht, hj)


@pytest.mark.parametrize("lam", [None, 60.0])
def test_griffin_mixer_one_shot_matches_jax(lam):
    """No state: the mixer's output against JAX's (Λ = 60: softplus(Λ)·8·r
    reaches several hundred, so a underflows on most channels)."""
    cfg_j, cfg_t = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp, tp = _params(1, lam)
    x = _x(11, 2, 9, 64)
    oj, sj = jg.griffin_mixer(jp, jnp.asarray(x), cfg_j)
    ot, st = tg.griffin_mixer(tp, _t(x), cfg_t)
    assert sj is None and st is None
    _close(ot, oj)


def test_griffin_mixer_prefill_then_decode_matches_jax_one_shot():
    """Prefill 9 tokens with a zero state, then decode 3 one at a time: each
    output equals JAX's one-shot mixer at that position, the state tensors
    (views of a stacked cache) are written in place, and the final state
    equals JAX's stateful run over all 12 tokens."""
    cfg_j, cfg_t = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp, tp = _params(2)
    x = _x(12, 2, 12, 64)
    oj, _ = jg.griffin_mixer(jp, jnp.asarray(x), cfg_j)
    _, sj = jg.griffin_mixer(jp, jnp.asarray(x), cfg_j,
                             jg.griffin_state_init(cfg_j, 2))
    stack = tg.griffin_state_init(cfg_t, 2, lead=(2,), device="cpu")
    state = {k: v[1] for k, v in stack.items()}          # views of rep 1
    ot, st = tg.griffin_mixer(tp, _t(x[:, :9]), cfg_t, state)
    assert st is state
    _close(ot, oj[:, :9], msg="prefill")
    for i in (9, 10, 11):
        ot, _ = tg.griffin_mixer(tp, _t(x[:, i:i + 1]), cfg_t, state)
        _close(ot, oj[:, i:i + 1], msg=f"decode at {i}")
    for name in ("h", "conv"):
        _close(stack[name][1], sj[name], msg=name)
        assert not bool(stack[name][0].any()), f"{name}: rep 0 was written"
