"""The port's end-to-end example (`repro_torch.examples.cnn_accelerator_sim`)
against `examples/cnn_accelerator_sim.py`: the same synthetic set, the
first QAT step's loss and gradients on JAX's initial parameters, the SGD
step, and a short run whose packed serving passes the example's drift
assertion on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.examples import cnn_accelerator_sim as ex  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.serving.quantize import quantize_cnn_params  # noqa: E402

KW = dict(n_classes=ex.N_CLASSES, width_mult=0.25, quant="logq6")


def _snap_relu_q(relu_q, where, absmax):
    """A wrapper of a package's ``relu_q`` that sets a pre-activation to
    exactly 0 where it is below 1e-6 of the tensor's largest magnitude.

    Log-coded operands cancel exactly in many conv sums; fp32 leaves a
    residual of about 1e-9 whose sign depends on the summation order, which
    differs between `lax.conv` and `F.conv2d`, so ReLU's mask differs there
    and with it the gradient behind it (27 of 25,088 of fire 0's e3
    pre-activations at JAX's initial parameters).  Snapping them to the
    exact 0 they stand for gives both packages the same mask."""
    def snapped(x, quant=None, qcfg=None, **kw):
        x = where(abs(x) < 1e-6 * absmax(x), 0.0 * x, x)
        return relu_q(x, quant, **({"qcfg": qcfg} if qcfg else {}), **kw)
    return snapped


@pytest.fixture(scope="module")
def start():
    """JAX's example start: `make_cnn("squeezenet", PRNGKey(0), ...)`, the
    synthetic set, and the same parameters bridged to the port."""
    params_j, apply_j = jcnn.make_cnn("squeezenet", jax.random.PRNGKey(0),
                                      **KW)
    batch = ex.synthetic_batch("cpu")
    batch_j = {"images": jnp.asarray(batch["images"].numpy()),
               "labels": jnp.asarray(batch["labels"].numpy()
                                     .astype(np.int32))}
    return params_j, apply_j, batch, batch_j


def test_synthetic_set_is_the_examples():
    """`examples/cnn_accelerator_sim.py:24-31`, recomputed."""
    r = np.random.default_rng(0)
    y = np.tile(np.arange(8), 4)
    x = r.normal(size=(32, 32, 32, 3)).astype(np.float32)
    grid = np.linspace(0, 2 * np.pi, 32)
    for i, yy in enumerate(y):
        x[i, :, :, 0] += 2.0 * np.sin((yy + 1) * grid)[None, :]
    b = ex.synthetic_batch("cpu")
    np.testing.assert_array_equal(b["images"].numpy(), x)
    np.testing.assert_array_equal(b["labels"].numpy(), y)


@pytest.mark.parametrize("snap", [False, True])
def test_first_qat_step_matches_jax(start, monkeypatch, snap):
    """Loss within 1e-4·(|loss|+1) of JAX's on the example's own path;
    with the cancellation residuals snapped to 0 in both packages (see
    `_snap_relu_q`), every gradient within 1e-4·(max|g|+1) of JAX's, and
    one clipped momentum step to the same parameters."""
    params_j, _, batch, batch_j = start
    if snap:
        monkeypatch.setattr(jcnn, "relu_q", _snap_relu_q(
            jcnn.relu_q, jnp.where, lambda x: jnp.max(jnp.abs(x))))
        monkeypatch.setattr(tcnn, "relu_q", _snap_relu_q(
            tcnn.relu_q, torch.where, lambda x: x.abs().max()))
    _, apply_j = jcnn.make_cnn("squeezenet", jax.random.PRNGKey(0), **KW)
    params = tcnn.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    _, apply_t = tcnn.make_cnn("squeezenet", 0, device="meta", **KW)
    if not snap:   # the forward only
        loss_j, aux_j = jax.jit(lambda p: jcnn.cnn_loss(apply_j, p, batch_j)
                                )(params_j)
        with torch.no_grad():
            loss, aux = tcnn.cnn_loss(apply_t, params, batch)
        assert abs(float(loss) - float(loss_j)) <= \
            1e-4 * (abs(float(loss_j)) + 1)
        assert float(aux["acc"]) == float(aux_j["acc"])
        return
    (loss_j, aux_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: jcnn.cnn_loss(apply_j, p, batch_j), has_aux=True))(params_j)
    loss, acc, grads = ex.loss_and_grads(apply_t, params, batch)
    assert abs(float(loss) - float(loss_j)) <= 1e-4 * (abs(float(loss_j))
                                                        + 1)
    assert float(acc) == float(aux_j["acc"])
    leaves_j = jax.tree.leaves(g_j)
    assert [tuple(g.shape) for g in grads] == [g.shape for g in leaves_j]
    g_max = max(float(jnp.max(jnp.abs(g))) for g in leaves_j)
    for g, gj in zip(grads, leaves_j):
        assert float(np.abs(g.numpy() - np.asarray(gj)).max()) <= \
            1e-4 * (g_max + 1)
    # the example's step (`examples/cnn_accelerator_sim.py:33-40`)
    gn = np.sqrt(sum(float(jnp.sum(g ** 2)) for g in leaves_j))
    mom = [torch.zeros_like(t) for t in ex.param_leaves(params)]
    ex.sgd_step(params, mom, grads, 0.02)
    for p, p0, gj in zip(ex.param_leaves(params), jax.tree.leaves(params_j),
                         leaves_j):
        want = np.asarray(p0) - 0.02 * np.asarray(gj) * min(1.0, 1.0 / gn)
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-6)


def _recording_relu_q(relu_q, out: list):
    """A wrapper of a package's ``relu_q`` that appends each
    pre-activation to ``out``."""
    def recorded(x, quant=None, qcfg=None, **kw):
        out.append(x)
        return relu_q(x, quant, **({"qcfg": qcfg} if qcfg else {}), **kw)
    return recorded


def test_first_qat_step_unsnapped_gap_is_the_relu_masks(start, monkeypatch):
    """The first QAT step with nothing snapped.  Every ReLU pre-activation
    of the port's forward agrees with JAX's within
    1e-5·(max|x|+1); where the two ReLU masks differ, both pre-activations
    are cancellation residuals below 1e-6·max|x|, and they are few (at most
    1 % of a layer's elements; 27 of fire 0's e3's 25,088 on a CPU).  The gradients, which those few masks move,
    stay within 1e-2·(max|g|+1) of JAX's (3.3e-3 measured on a CPU); the
    snapped case of `test_first_qat_step_matches_jax` holds them to 1e-4."""
    params_j, apply_j, batch, batch_j = start
    params = tcnn.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    _, apply_t = tcnn.make_cnn("squeezenet", 0, device="meta", **KW)
    pre_j, pre_t = [], []

    def forward_j(p):   # the traced pre-activations are the outputs
        apply_j(p, batch_j["images"])
        return list(pre_j)
    with monkeypatch.context() as m:
        m.setattr(jcnn, "relu_q", _recording_relu_q(jcnn.relu_q, pre_j))
        m.setattr(tcnn, "relu_q", _recording_relu_q(tcnn.relu_q, pre_t))
        pre_j = [np.asarray(x, np.float64)
                 for x in jax.jit(forward_j)(params_j)]
        with torch.no_grad():
            apply_t(params, batch["images"])
    pre_t = [x.double().numpy() for x in pre_t]
    assert len(pre_t) == len(pre_j) > 0
    for xt, xj in zip(pre_t, pre_j):
        amax = float(np.abs(xj).max())
        assert float(np.abs(xt - xj).max()) <= 1e-5 * (amax + 1)
        differ = (xt > 0) != (xj > 0)
        assert int(differ.sum()) <= 1e-2 * differ.size
        assert float(np.abs(xt[differ]).max(initial=0.0)) < 1e-6 * amax
        assert float(np.abs(xj[differ]).max(initial=0.0)) < 1e-6 * amax
    _, g_j = jax.jit(jax.value_and_grad(
        lambda p: jcnn.cnn_loss(apply_j, p, batch_j), has_aux=True))(params_j)
    _, _, grads = ex.loss_and_grads(apply_t, params, batch)
    leaves_j = jax.tree.leaves(g_j)
    g_max = max(float(jnp.max(jnp.abs(g))) for g in leaves_j)
    gap = max(float(np.abs(g.numpy() - np.asarray(gj)).max())
              for g, gj in zip(grads, leaves_j))
    assert gap <= 1e-2 * (g_max + 1)


def test_short_run_serves_within_the_drift_limit(capsys):
    """A few tens of QAT steps from the port's own seed, then the packed
    serving of `serve_packed` (the kernel's plain version on the CPU): the
    example's drift assertion holds, and the dataflow walk prints the four
    nets as the modelled FPGA."""
    loss, acc, params, apply_fn, batch = ex.train_quantized_cnn(
        steps=20, device="cpu")
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    served = ex.serve_packed(params, apply_fn, batch)
    assert served["drift"] < served["limit"]
    assert abs(served["acc"] - acc) < 0.2
    perf = ex.dataflow_walk()
    assert sorted(perf) == sorted(ex.NETWORKS)
    out = capsys.readouterr().out
    assert "serving acc" in out and "vgg16" in out


def test_a_flipped_code_is_reported(monkeypatch):
    """When the packed path drifts, the assertion names the first conv
    whose output codes differ from the fake-quant path's, and how many."""
    params, apply_fn = tcnn.make_cnn("squeezenet", 0, device="cpu", **KW)
    batch = ex.synthetic_batch("cpu")
    assert ex.first_code_difference(
        apply_fn, params, quantize_cnn_params(params), batch["images"]) == \
        "no conv's output codes differ"
    from repro_torch.kernels import ops
    conv = ops.conv2d

    def off(x, qt, **kw):   # one large output of each third packed conv
        y = conv(x, qt, **kw)
        off.calls += 1
        if off.calls % 26 == 3:
            y = y.clone()
            y[0, 0, 0, 0] = 10 * y.abs().max() + 1
        return y
    off.calls = 0
    monkeypatch.setattr(ops, "conv2d", off)
    with pytest.raises(AssertionError, match=r"conv 2 of 26 .* is the first "
                       r"whose codes differ: \d+ of"):
        ex.serve_packed(params, apply_fn, batch)


def test_main_runs_on_the_cpu(monkeypatch, capsys):
    """The module's entry point with ``--device cpu`` (a short QAT run)."""
    train = ex.train_quantized_cnn
    monkeypatch.setattr(ex, "train_quantized_cnn",
                        lambda device=None: train(steps=10, device=device))
    ex.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "2. serving with packed int8 log codes" in out
    assert "Zynq-7020 at 200 MHz" in out and "TPU" not in out
