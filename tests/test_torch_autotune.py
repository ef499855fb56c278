"""The port's launch-knob tuner (`repro_torch.kernels.autotune`), its
table tool (`repro_torch.tools.build_autotune_table`) and its wiring into
`ops.conv2d` / `ops.attention`, held against the JAX package's tuner where
the two share a contract (keys, the layered tiers, persistence, partial
configs, warnings).

The cases of `tests/test_autotune.py` that apply are ported; the port's
own cases check the knobs' contracts, the heuristic kept bit for bit on a
table miss, the checked-in table, the traffic model under explicit knobs
and the cold start.  The test marked ``cuda`` times a sweep on the card."""

import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the machine with the card has no JAX: only the cuda test runs there
    from repro.kernels import autotune as jautotune
except ImportError:
    jautotune = None

from repro_torch.core.logquant import LogQuantConfig  # noqa: E402
from repro_torch.core.logquant import quantize_tensor  # noqa: E402
from repro_torch.kernels import autotune, ops  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import log_conv2d as tlc  # noqa: E402
from repro_torch.models.cnn import zoo_conv_shapes  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.tools import build_autotune_table as table_tool  # noqa: E402

ARGS = (1, 8, 8, 5, 3, 7)

REAL_PACKAGED_DIR = autotune.PACKAGED_DIR  # before the fixture repoints it


@pytest.fixture(autouse=True)
def _isolated_table(tmp_path, monkeypatch):
    """Every test gets its own user tier and an empty packaged tier."""
    monkeypatch.setenv(autotune.ENV_PATH, str(tmp_path / "table.json"))
    monkeypatch.setattr(autotune, "PACKAGED_DIR", str(tmp_path / "packaged"))
    autotune.reset_cache()
    yield
    autotune.reset_cache()


@pytest.fixture()
def _fresh_warnings(monkeypatch):
    monkeypatch.setattr(ops, "_WARNED_ONCE", set())


@pytest.fixture()
def _packaged(monkeypatch):
    monkeypatch.setattr(autotune, "PACKAGED_DIR", REAL_PACKAGED_DIR)
    autotune.reset_cache()


def _needs_jax():
    if jautotune is None:
        pytest.skip("needs jax: the JAX package is the reference")


def _write_packaged(backend: str, entries: dict) -> str:
    os.makedirs(autotune.PACKAGED_DIR, exist_ok=True)
    path = autotune.packaged_table_path(backend)
    with open(path, "w") as f:
        json.dump({"version": autotune.SCHEMA_VERSION, "entries": entries},
                  f)
    return path


def _lookup_counts(op="conv2d") -> dict:
    return {r: obs_metrics.REGISTRY.counter("autotune_lookup", op=op,
                                            result=r).value
            for r in ("hit_user", "hit_warm", "miss")}


def _conv_inputs(seed, B, H, W, C, K, Cout, groups=1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32))
    qt = quantize_tensor(torch.from_numpy(
        rng.normal(size=(K, K, C // groups, Cout)).astype(np.float32)))
    return x, qt


# --------------------------------------------------------------- keys


KEY_SHAPES = [  # B, H, W, C, K, Cout, stride, padding, groups
    (1, 8, 8, 5, 3, 7, 1, "SAME", 1),
    (8, 224, 224, 3, 3, 64, 1, "SAME", 1),
    (1, 112, 112, 64, 3, 64, 2, "SAME", 64),
    (2, 9, 9, 4, 3, 5, 2, "VALID", 1),
    (1, 8, 8, 3, 5, 4, 2, 2, 1),
    (1, 8, 8, 3, 3, 5, 1, ((1, 2), (0, 1)), 1),
]


@pytest.mark.parametrize("shape", KEY_SHAPES)
def test_conv_key_equals_jax_but_backend(shape):
    _needs_jax()
    B, H, W, C, K, Cout, stride, padding, groups = shape
    kw = dict(stride=stride, padding=padding, groups=groups)
    for bits in (6, 4):
        mine = autotune.conv_key(B, H, W, C, K, Cout, **kw,
                                 cfg=LogQuantConfig(bits=bits))
        from repro.core.logquant import LogQuantConfig as JCfg
        theirs = jautotune.conv_key(B, H, W, C, K, Cout, **kw,
                                    cfg=JCfg(bits=bits), backend="tpu")
        assert mine.split("|")[1] == "cuda"
        assert mine.replace("|cuda|", "|tpu|", 1) == theirs
    # the kernel module re-exports it where it was imported from
    assert tlc.conv_key is autotune.conv_key


@pytest.mark.parametrize("shape", [
    (1, 1, 4096, 8, 2, 64, True, None), (4, 1, 64, 8, 1, 256, True, None),
    (1, 7, 7, 10, 1, 256, True, 2048), (2, 16, 128, 8, 2, 64, False, 64)])
def test_attention_key_equals_jax_but_backend(shape):
    _needs_jax()
    *args, causal, window = shape
    mine = autotune.attention_key(*args, causal=causal, window=window)
    theirs = jautotune.attention_key(*args, causal=causal, window=window,
                                     backend="tpu")
    assert mine.replace("|cuda|", "|tpu|", 1) == theirs
    assert tfa.attention_key is autotune.attention_key


def test_key_carries_shape_stride_groups_backend():
    k1 = autotune.conv_key(*ARGS, backend="cpu")
    assert autotune.conv_key(*ARGS, backend="cpu") == k1
    for other in (autotune.conv_key(1, 8, 8, 5, 3, 9, backend="cpu"),
                  autotune.conv_key(*ARGS, stride=2, backend="cpu"),
                  autotune.conv_key(*ARGS, padding="VALID", backend="cpu"),
                  autotune.conv_key(*ARGS, backend="cuda"),
                  autotune.conv_key(*ARGS, cfg=LogQuantConfig(bits=4),
                                    backend="cpu")):
        assert other != k1


def test_key_namespaces_distinct_per_op():
    ck = autotune.conv_key(*ARGS)
    ak = autotune.attention_key(1, 8, 8, 5, 1, 7)
    assert ck.startswith("conv2d|") and ak.startswith("attention|")
    assert autotune.key_backend(ck) == autotune.key_backend(ak) == "cuda"


def test_attention_key_carries_shape_mask_backend():
    args = (2, 16, 128, 8, 2, 64)
    k1 = autotune.attention_key(*args)
    for other in (autotune.attention_key(2, 16, 128, 8, 4, 64),
                  autotune.attention_key(2, 16, 256, 8, 2, 64),
                  autotune.attention_key(*args, causal=False),
                  autotune.attention_key(*args, window=64),
                  autotune.attention_key(*args, backend="cpu")):
        assert other != k1


# --------------------------------------------------------- persistence


def test_record_lookup_roundtrip_persists():
    key = autotune.conv_key(*ARGS)
    cfg = dict(splits=2, tile=None)
    autotune.record(key, cfg, 12.5)
    assert autotune.lookup(key) == cfg
    autotune.reset_cache()          # force re-read from disk
    assert autotune.lookup(key) == cfg
    table = json.load(open(autotune.table_path()))
    assert table["version"] == autotune.SCHEMA_VERSION
    assert table["entries"][key]["us"] == 12.5


def test_attention_record_lookup_roundtrip_persists():
    key = autotune.attention_key(1, 1, 4096, 8, 2, 64)
    autotune.record(key, dict(splits=8), 42.0)
    autotune.reset_cache()
    assert autotune.lookup(key) == dict(splits=8)
    ck = autotune.conv_key(*ARGS)   # conv entries share the file
    autotune.record(ck, dict(splits=1, tile=None), 1.0)
    assert autotune.lookup(key) == dict(splits=8)
    assert autotune.lookup(ck) is not None


def test_stale_schema_version_invalidates_table():
    key = autotune.conv_key(*ARGS)
    autotune.record(key, dict(splits=2), 1.0)
    autotune.reset_cache()
    path = autotune.table_path()
    table = json.load(open(path))
    table["version"] = autotune.SCHEMA_VERSION + 1
    json.dump(table, open(path, "w"))
    before = open(path).read()
    assert autotune.lookup(key) is None  # stale entries are not served
    assert open(path).read() == before   # … and the file is left as it is


def test_corrupt_table_is_ignored():
    with open(autotune.table_path(), "w") as f:
        f.write("{not json")
    assert autotune.lookup("anything") is None
    autotune.record("k", dict(splits=4), 1.0)  # and is recoverable
    autotune.reset_cache()
    assert autotune.lookup("k") == dict(splits=4)


def test_layered_lookup_precedence_and_counter_labels():
    key = autotune.conv_key(*ARGS)
    c0 = _lookup_counts()
    assert autotune.lookup(key) is None                   # nothing anywhere
    _write_packaged("cuda", {key: {"config": dict(splits=2), "us": 1.0}})
    autotune.reset_cache()
    assert autotune.lookup(key) == dict(splits=2)         # packaged tier
    autotune.record(key, dict(splits=1), 2.0)
    assert autotune.lookup(key) == dict(splits=1)         # user tier wins
    c1 = _lookup_counts()
    assert {r: c1[r] - c0[r] for r in c1} == \
        {"miss": 1, "hit_warm": 1, "hit_user": 1}


def test_packaged_tier_keyed_per_backend():
    key_cuda = autotune.conv_key(*ARGS)
    key_cpu = autotune.conv_key(*ARGS, backend="cpu")
    _write_packaged("cuda", {key_cuda: {"config": dict(splits=2)}})
    assert autotune.lookup(key_cuda) == dict(splits=2)
    assert autotune.lookup(key_cpu) is None  # no cpu.json → miss, no error


def test_env_path_overrides_user_cache(tmp_path, monkeypatch):
    """$REPRO_TORCH_AUTOTUNE_PATH beats ~/.cache/repro_torch/…, and neither
    is the JAX package's user tier."""
    key = autotune.conv_key(*ARGS)
    monkeypatch.delenv(autotune.ENV_PATH)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("REPRO_AUTOTUNE_PATH", str(tmp_path / "jax.json"))
    autotune.reset_cache()
    assert autotune.table_path() == str(
        tmp_path / "home" / ".cache" / "repro_torch" / "kernel_autotune.json")
    autotune.record(key, dict(splits=2), 1.0)          # lands in ~/.cache
    assert not (tmp_path / "jax.json").exists()
    autotune.reset_cache()
    assert autotune.lookup(key) == dict(splits=2)
    monkeypatch.setenv(autotune.ENV_PATH, str(tmp_path / "env_table.json"))
    autotune.reset_cache()
    assert autotune.lookup(key) is None                 # env tier shadows
    autotune.record(key, dict(splits=4), 1.0)
    autotune.reset_cache()
    assert autotune.lookup(key) == dict(splits=4)


def test_user_tier_is_not_the_jax_packages(tmp_path, monkeypatch):
    _needs_jax()
    monkeypatch.delenv(autotune.ENV_PATH)
    monkeypatch.delenv("REPRO_AUTOTUNE_PATH", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert autotune.table_path() != jautotune.table_path()
    assert autotune.ENV_PATH != "REPRO_AUTOTUNE_PATH"


def test_record_never_writes_packaged_tier():
    key = autotune.conv_key(*ARGS)
    path = _write_packaged("cuda", {key: {"config": dict(splits=2)}})
    before = open(path).read()
    autotune.record(key, dict(splits=1), 2.0)
    assert open(path).read() == before
    user = json.load(open(autotune.table_path()))
    assert user["entries"][key]["config"] == dict(splits=1)


def test_stale_packaged_schema_is_ignored():
    key = autotune.conv_key(*ARGS)
    os.makedirs(autotune.PACKAGED_DIR, exist_ok=True)
    with open(autotune.packaged_table_path("cuda"), "w") as f:
        json.dump({"version": autotune.SCHEMA_VERSION - 1,
                   "entries": {key: {"config": dict(splits=2)}}}, f)
    assert autotune.lookup(key) is None


def test_record_merges_concurrent_writers():
    key_a = autotune.conv_key(*ARGS)
    key_b = autotune.attention_key(1, 1, 4096, 8, 2, 64)
    autotune._load()              # process B's in-memory snapshot: empty
    with open(autotune.table_path(), "w") as f:        # process A lands
        json.dump({"version": autotune.SCHEMA_VERSION,
                   "entries": {key_a: {"config": dict(splits=2),
                                       "us": 5.0}}}, f)
    autotune.record(key_b, dict(splits=8), 7.0)        # process B
    disk = json.load(open(autotune.table_path()))
    assert disk["entries"][key_a]["config"] == dict(splits=2)  # survived
    assert disk["entries"][key_b]["config"] == dict(splits=8)
    autotune.record(key_a, dict(splits=1), 1.0)        # B's own wins
    disk = json.load(open(autotune.table_path()))
    assert disk["entries"][key_a]["config"] == dict(splits=1)
    assert disk["entries"][key_b]["config"] == dict(splits=8)


def test_autotune_reps_zero_raises():
    x, qt = _conv_inputs(0, 1, 4, 4, 2, 3, 4)
    with pytest.raises(ValueError, match="reps >= 1"):
        autotune.autotune_conv2d(x, qt.packed, qt.scale, qt.cfg, reps=0)
    q, k = torch.randn(1, 4, 2, 8), torch.randn(1, 4, 2, 8)
    with pytest.raises(ValueError, match="reps >= 1"):
        autotune.autotune_attention(q, k, k, reps=-1)
    # and a sweep needs the card: device time, not the host's clock
    with pytest.raises(ValueError, match="on the card"):
        autotune.autotune_conv2d(x, qt.packed, qt.scale, qt.cfg, reps=1)


# ------------------------------------------------------ ops resolution


def _spy_conv(monkeypatch):
    seen = []
    wrapper = ops.log_conv2d_fused

    def spy(*a, config=None, **kw):
        seen.append(dict(config))
        return wrapper(*a, config=config, **kw)
    monkeypatch.setattr(ops, "log_conv2d_fused", spy)
    return seen


def test_partial_conv_config_fills_from_table(monkeypatch):
    """A partial `ConvConfig` keeps its fields and takes the rest from the
    table, field by field; a fully pinned one consults no table."""
    x, qt = _conv_inputs(3, *ARGS)
    key = autotune.conv_key(*ARGS, cfg=qt.cfg)
    autotune.record(key, dict(splits=2, tile=None), 9.0)
    seen = _spy_conv(monkeypatch)
    y = ops.conv2d(x, qt, impl="cuda", config=ops.ConvConfig(lane_pack=1))
    assert seen[-1] == dict(splits=2, tile=None)   # from the table
    y_ref = ops.conv2d(x, qt, impl="ref")
    torch.testing.assert_close(y, y_ref, rtol=0,
                               atol=1e-4 * (float(y_ref.abs().max()) + 1))
    c0 = _lookup_counts()
    ops.conv2d(x, qt, impl="cuda", config=dict(splits=1))
    assert seen[-1] == dict(splits=1, tile=None)   # explicit beats table
    assert _lookup_counts() == c0                  # and needs no lookup


def test_table_beats_heuristic_and_miss_keeps_it(monkeypatch):
    x, qt = _conv_inputs(4, *ARGS)
    seen = _spy_conv(monkeypatch)
    ops.conv2d(x, qt, impl="cuda")
    assert seen[-1] == dict(splits=None, tile=None)  # a miss: heuristic
    _write_packaged("cuda", {autotune.conv_key(*ARGS, cfg=qt.cfg): {
        "config": dict(splits=2, tile=None)}})
    autotune.reset_cache()
    ops.conv2d(x, qt, impl="cuda")
    assert seen[-1] == dict(splits=2, tile=None)


def test_resolved_once_per_shape_and_process():
    """The lookup is counted once a shape (the JAX package's once a
    trace); `reset_cache` and `record` start over."""
    x, qt = _conv_inputs(5, *ARGS)
    c0 = _lookup_counts()
    for _ in range(3):
        ops.conv2d(x, qt, impl="cuda")
    assert _lookup_counts()["miss"] - c0["miss"] == 1
    autotune.reset_cache()
    ops.conv2d(x, qt, impl="cuda")
    assert _lookup_counts()["miss"] - c0["miss"] == 2
    autotune.record("unrelated", {}, 1.0)
    ops.conv2d(x, qt, impl="cuda")
    assert _lookup_counts()["miss"] - c0["miss"] == 3


def test_refused_table_config_falls_back_with_one_warning(
        monkeypatch, _fresh_warnings):
    x, qt = _conv_inputs(6, *ARGS)   # 2 stages: 3 shares cannot cover them
    _write_packaged("cuda", {autotune.conv_key(*ARGS, cfg=qt.cfg): {
        "config": dict(splits=3, tile=None)}})
    autotune.reset_cache()
    seen = _spy_conv(monkeypatch)
    with pytest.warns(UserWarning, match="breaks the launcher's contract"):
        ops.conv2d(x, qt, impl="cuda")
    assert seen[-1] == dict(splits=None, tile=None)
    autotune.reset_cache()
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # one-shot
        ops.conv2d(x, qt, impl="cuda")


def test_autotune_suppressed_by_conv_config_warns_once(_fresh_warnings):
    x, qt = _conv_inputs(4, *ARGS)
    cfg = dict(splits=2, lane_pack=1)
    with pytest.warns(UserWarning, match="autotune=True is a no-op"):
        ops.conv2d(x, qt, impl="cuda", config=cfg, autotune=True)
    assert not autotune._load()["entries"]      # and no sweep ran
    autotune.reset_cache()
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # one-shot: second call quiet
        ops.conv2d(x, qt, impl="cuda", config=cfg, autotune=True)


def test_autotune_suppressed_by_attention_config_warns(_fresh_warnings):
    q, k = torch.randn(1, 8, 2, 8), torch.randn(1, 8, 2, 8)
    with pytest.warns(UserWarning, match="autotune=True is a no-op"):
        ops.attention(q, k, k, impl="cuda", autotune=True,
                      config=ops.AttentionConfig(splits=1))
    assert not autotune._load()["entries"]


def test_attention_splits_from_table_and_explicit(monkeypatch):
    B, Tq, Tk, H, Hkv, D = 2, 1, 200, 4, 2, 16
    seen = []
    wrapper = ops.flash_attention_cuda

    def spy(*a, config=None, **kw):
        seen.append(dict(config))
        return wrapper(*a, config=config, **kw)
    monkeypatch.setattr(ops, "flash_attention_cuda", spy)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((B, Tq, H, D), generator=gen)
    k, v = (torch.randn((B, Tk, Hkv, D), generator=gen) for _ in range(2))
    want = ops.attention(q, k, v, impl="ref")
    ops.attention(q, k, v, impl="cuda")
    assert seen[-1] == dict(splits=None)
    key = autotune.attention_key(B, Tq, Tk, H, Hkv, D)
    _write_packaged("cuda", {key: {"config": dict(splits=2)}})
    autotune.reset_cache()
    c0 = _lookup_counts("attention")
    out = ops.attention(q, k, v, impl="cuda",
                        config=ops.AttentionConfig(block_k=16))
    assert seen[-1] == dict(splits=2)
    assert _lookup_counts("attention")["hit_warm"] - c0["hit_warm"] == 1
    torch.testing.assert_close(out, want, rtol=0, atol=2e-4)
    ops.attention(q, k, v, impl="cuda", config=ops.AttentionConfig(splits=4))
    assert seen[-1] == dict(splits=4)


def test_table_splits_do_not_apply_to_tensor_core_calls(monkeypatch):
    """A table's split count is the split variant's; a bf16 prefill that
    takes the tensor-core variant launches without it."""
    B, T, H, Hkv, D = 1, 64, 4, 1, 64
    key = autotune.attention_key(B, T, T, H, Hkv, D)
    _write_packaged("cuda", {key: {"config": dict(splits=2)}})
    autotune.reset_cache()
    q = torch.randn(B, T, H, D).to(torch.bfloat16)
    k = torch.randn(B, T, Hkv, D).to(torch.bfloat16)
    ops.attention(q, k, k, impl="cuda")                    # bf16: tensor core
    ops.attention(q.float(), k.float(), k.float(), impl="cuda")  # split
    with pytest.raises(ValueError, match="splits=2"):
        ops.attention(q, k, k, impl="cuda",
                      config=ops.AttentionConfig(splits=2))


# ------------------------------------------------------------ contracts


def _zoo(batches=(1, 8)):
    return [s for b in batches for s in zoo_conv_shapes(batch=b)]


def _geo(s, **knobs):
    return tlc.log_conv2d_geometry(s["B"], s["H"], s["W"], s["C"], s["K"],
                                   s["Cout"], s["stride"], s["padding"],
                                   s["groups"], 132, **knobs)


def test_every_candidate_of_every_zoo_shape_keeps_the_contract():
    total = 0
    for s in _zoo():
        args = (s["B"], s["H"], s["W"], s["C"], s["K"], s["Cout"])
        kw = dict(stride=s["stride"], padding=s["padding"],
                  groups=s["groups"])
        cands = autotune.candidate_configs(*args, **kw, max_candidates=None)
        heur = _geo(s)
        first = _geo(s, splits=cands[0]["splits"], tile=cands[0]["tile"])
        assert first == heur                       # the heuristic's own first
        seen = set()
        for c in cands:
            g = _geo(s, splits=c["splits"], tile=c["tile"])   # no raise
            sig = (g["splits"], g.get("tile"))
            assert sig not in seen                 # deduped after clamping
            seen.add(sig)
        assert len(autotune.candidate_configs(*args, **kw)) <= 12
        total += len(cands)
    assert total > 2 * 61
    for a in table_tool.attention_walk():
        B, Tq, Tk, H, Hkv, D = a["shape"][:6]
        qdt = table_tool._DTYPES[a["q_dtype"]]
        kvdt = table_tool._DTYPES[a["kv_dtype"]]
        for c in autotune.attention_candidate_configs(
                B, Tq, Tk, H, Hkv, D, q_dtype=qdt, kv_dtype=kvdt,
                max_candidates=None):
            tfa.flash_attention_geometry(B, Tq, Tk, H, Hkv, D, qdt, kvdt,
                                         splits=c["splits"])


def test_dense_candidates_respect_the_partials_budget():
    s = dict(B=8, H=56, W=56, C=64, K=3, Cout=64, stride=1, padding="SAME",
             groups=1)
    args = (8, 56, 56, 64, 3, 64)
    budget = 8 << 20
    cands = autotune.candidate_configs(*args, budget=budget,
                                       max_candidates=None)
    M = 8 * 56 * 56
    for c in cands[1:]:
        assert c["splits"] == 1 or c["splits"] * M * 64 * 4 <= budget
    assert cands[0] == dict(splits=_geo(s)["splits"], tile=None)


CONV_VIOLATIONS = [  # shape (B, H, W, C, K, Cout, stride, groups), knobs
    ((1, 8, 8, 5, 3, 7, 1, 1), dict(splits=0), "splits"),
    ((1, 8, 8, 5, 3, 7, 1, 1), dict(splits=3), "splits"),      # > stages
    ((1, 4, 4, 320, 1, 8, 1, 1), dict(splits=7), "splits"),    # one empty
    ((1, 8, 8, 8, 3, 8, 1, 8), dict(tile=(4, 8, 12)), "tile"),  # ct
    ((1, 8, 8, 8, 3, 8, 1, 8), dict(tile=(4, 6, 8)), "tile"),   # tw % 4
    ((1, 8, 8, 8, 3, 8, 1, 8), dict(tile=(0, 8, 8)), "tile"),   # th
    ((1, 8, 8, 8, 3, 8, 1, 8), dict(tile=(64, 8, 32)), "tile"),  # threads
    ((1, 8, 8, 8, 3, 8, 4, 8), dict(tile=(32, 4, 32)), "tile"),  # smem
    ((1, 8, 8, 8, 3, 8, 1, 8), dict(tile=(4, 8)), "tile"),      # not 3
]


@pytest.mark.parametrize("shape,knobs,name", CONV_VIOLATIONS)
def test_conv_contract_violation_raises(shape, knobs, name):
    B, H, W, C, K, Cout, stride, groups = shape
    with pytest.raises(ValueError, match=f"^{name}="):
        tlc.log_conv2d_geometry(B, H, W, C, K, Cout, stride, "SAME", groups,
                                **knobs)
    x, qt = _conv_inputs(7, B, H, W, C, K, Cout, groups)
    with pytest.raises(ValueError, match=f"^{name}="):
        ops.conv2d(x, qt, impl="cuda", stride=stride, groups=groups,
                   config=knobs)
    with pytest.raises(ValueError, match=f"^{name}="):
        tlc.log_conv2d_fused(x, qt.packed, qt.scale, stride=stride,
                             groups=groups, config=knobs)


ATTN_VIOLATIONS = [  # B, Tq, Tk, H, Hkv, D, dtype, splits
    (1, 1, 200, 4, 2, 16, torch.float32, 0),
    (1, 1, 200, 4, 2, 16, torch.float32, 8),       # > stages (7)
    (1, 1, 200, 4, 2, 16, torch.float32, 5),       # chunks of 64: one empty
    (1, 1, 8192, 4, 2, 16, torch.float32, 65),     # > MAX_SPLITS
    (1, 64, 64, 4, 1, 64, torch.bfloat16, 2),      # tensor-core variant
]


@pytest.mark.parametrize("case", ATTN_VIOLATIONS)
def test_attention_contract_violation_raises(case):
    B, Tq, Tk, H, Hkv, D, dt, splits = case
    with pytest.raises(ValueError, match="^splits="):
        tfa.flash_attention_geometry(B, Tq, Tk, H, Hkv, D, dt, dt,
                                     splits=splits)
    q = torch.randn(B, Tq, H, D).to(dt)
    k = torch.randn(B, Tk, Hkv, D).to(dt)
    with pytest.raises(ValueError, match="^splits="):
        ops.attention(q, k, k, impl="cuda",
                      config=ops.AttentionConfig(splits=splits))


def _pr23_dense(B, Ho, Wo, cin_g, cout_g, K, groups, n_sm):
    """The dense heuristic as it stood before the knobs (for the test)."""
    M = B * Ho * Wo
    m_tiles, n_tiles = -(-M // 128), -(-cout_g // 64)
    tiles = m_tiles * n_tiles * groups
    stages = -(-K * K * cin_g // 32)
    want = min(stages, max(1, round(2 * n_sm / tiles)))
    while True:
        sps = -(-stages // want)
        splits = -(-stages // sps)
        if tiles * splits >= n_sm or splits == stages:
            break
        want += 1
    return splits, sps, tiles * splits


def _pr23_depthwise(B, Ho, Wo, Cout, K, stride, n_sm):
    cdiv = lambda a, b: -(-a // b)                      # noqa: E731
    tw_max = 16 if stride == 1 else 8
    tw = 4 * cdiv(cdiv(Wo, cdiv(Wo, tw_max)), 4)
    tiles_w = cdiv(Wo, tw)
    ct = min(32, 4 * tlc._next_pow2(cdiv(Cout, 4)))

    def rows(ct):
        per_row = ct // 4 * (tw // 4)
        for th in range(min(Ho, 256 // per_row), 0, -1):
            th = cdiv(Ho, cdiv(Ho, th))
            if tlc._depthwise_smem(th, tw, ct, K, stride) <= 232448:
                return th, B * cdiv(Ho, th) * tiles_w * cdiv(Cout, ct)

    th, blocks = rows(ct)
    while blocks < n_sm and ct > 16:
        ct //= 2
        th, blocks = rows(ct)
    tiles_h = cdiv(Ho, th)
    while blocks < n_sm and th > 1:
        tiles_h += 1
        th = cdiv(Ho, tiles_h)
        blocks = B * cdiv(Ho, th) * tiles_w * cdiv(Cout, ct)
    return (th, tw, ct), blocks


@pytest.mark.parametrize("n_sm", [132, 114])
def test_none_knobs_keep_the_heuristic_geometry(n_sm):
    """A table miss launches exactly what the heuristic launched before the
    knobs: every zoo shape at batch 1 and 8."""
    for s in _zoo():
        g = tlc.log_conv2d_geometry(s["B"], s["H"], s["W"], s["C"], s["K"],
                                    s["Cout"], s["stride"], s["padding"],
                                    s["groups"], n_sm, splits=None, tile=None)
        pads = tlc.normalize_padding(s["padding"], s["K"], s["stride"],
                                     s["H"], s["W"])
        Ho = tlc._out_size(s["H"], s["K"], s["stride"], pads[0])
        Wo = tlc._out_size(s["W"], s["K"], s["stride"], pads[1])
        cin_g = s["C"] // s["groups"]
        if cin_g == 1:
            assert (g["tile"], g["blocks"]) == _pr23_depthwise(
                s["B"], Ho, Wo, s["Cout"], s["K"], s["stride"], n_sm)
        else:
            assert (g["splits"], g["stages_per_split"], g["blocks"]) == \
                _pr23_dense(s["B"], Ho, Wo, cin_g, s["Cout"] // s["groups"],
                            s["K"], s["groups"], n_sm)
    for a in table_tool.attention_walk():
        B, Tq, Tk, H, Hkv, D = a["shape"][:6]
        g = tfa.flash_attention_geometry(B, Tq, Tk, H, Hkv, D, torch.float32,
                                         torch.float32, n_sm)
        tiles = B * Hkv * -(-(H // Hkv * Tq) // 8)
        splits = max(1, min(64, -(-n_sm // tiles), Tk // 64))
        kps = -(-(-(-Tk // 32)) // splits) * 32
        assert (g["splits"], g["keys_per_split"]) == (-(-Tk // kps), kps)


# ------------------------------------------------ traffic under knobs
# (B1's bytes under explicit knobs are walked block by block in
# tests/test_torch_benchmarks.py, test_cuda_bytes_match_tile_walk)


def test_attention_bytes_follow_explicit_splits():
    args = (1, 1, 4096, 8, 2, 64)
    one = tfa.attention_traffic_bytes("cuda", *args, config=dict(splits=1))
    for s in (2, 8, 64):
        got = tfa.attention_traffic_bytes("cuda", *args,
                                          config=dict(splits=s))
        g = tfa.flash_attention_geometry(*args, torch.float32, torch.float32,
                                         splits=s)
        part = 2 * 4 * s * 1 * 2 * g["row_blocks"] * 8 * (64 + 2)
        assert got["total"] == one["total"] + part


# ------------------------------------------------- the packaged table


def test_checked_in_table_passes_check_and_regenerates(tmp_path, _packaged):
    assert table_tool.main(["--check"]) == 0
    out = tmp_path / "cuda.json"
    assert table_tool.main(["--out", str(out)]) == 0
    assert out.read_bytes() == open(
        autotune.packaged_table_path("cuda"), "rb").read()
    # a stale schema fails the gate
    table = json.loads(out.read_text())
    table["version"] += 1
    out.write_text(json.dumps(table))
    assert table_tool.main(["--check", "--out", str(out)]) == 1
    # and so does a missing key
    table["version"] -= 1
    table["entries"].pop(next(iter(table["entries"])))
    out.write_text(json.dumps(table))
    assert table_tool.main(["--check", "--out", str(out)]) == 1


def test_table_tool_measure_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="on the card"):
        table_tool.main(["--measure", "--out", str(tmp_path / "t.json")])
    assert not (tmp_path / "t.json").exists()


def test_table_tool_measure_writes_only_the_user_tier(monkeypatch, _packaged):
    """``--measure`` without ``--out`` leaves every table file alone: its
    winners land in the user tier (through the tuners' `record`)."""
    packaged = autotune.packaged_table_path("cuda")
    before = open(packaged, "rb").read()
    monkeypatch.setattr(table_tool, "_needs_card", lambda: None)
    monkeypatch.setattr(table_tool, "build_table", lambda meta, measure:
                        {"version": autotune.SCHEMA_VERSION, "entries": {}})
    monkeypatch.setattr(table_tool, "write_table", lambda table, path:
                        pytest.fail(f"--measure wrote {path}"))
    assert table_tool.main(["--measure"]) == 0
    assert open(packaged, "rb").read() == before


@pytest.mark.parametrize("arch", table_tool.SERVE_ARCHS)
def test_table_tool_keeps_one_split_at_short_decode(arch):
    """A decode call over a few dozen keys is bound by its fixed time and
    the combine of split partials, not the idle SMs: the score keeps the
    heuristic's single split, as the card measured for gemma-2b."""
    a = next(a for a in table_tool.serve_attention_shapes()
             if a["source"] == f"{arch} decode")
    cfg, us = table_tool.analytic_attention_winner(a)
    assert cfg == {"splits": 1} and us > table_tool.ATTN_FIXED_US


def test_table_tool_ties_go_to_the_heuristic():
    s = dict(B=8, H=224, W=224, C=64, K=3, Cout=64, stride=1, padding="SAME",
             groups=1, nets=["vgg16"])
    cfg, us = table_tool.analytic_conv_winner(s)
    assert cfg == autotune.candidate_configs(8, 224, 224, 64, 3, 64)[0]
    assert us > 0


def test_packaged_table_covers_serve_attention_shapes(_packaged):
    entries = autotune._load_packaged("cuda")
    for a in table_tool.serve_attention_shapes():
        assert table_tool.attention_key_of(a) in entries


def test_cold_start_cpu_forward_resolves_every_conv_from_packaged(
        _packaged, monkeypatch):
    """A CPU forward of MobileNet v1 at 224 px on packed weights with
    ``conv_impl="cuda"`` and an empty user tier: every conv's knobs come
    from the packaged tier."""
    from repro_torch.models.cnn import CNNS, make_cnn
    from repro_torch.serving.quantize import quantize_cnn_params
    seen = _spy_conv(monkeypatch)
    params, _ = make_cnn("mobilenet_v1", device="cpu")
    qp = quantize_cnn_params(params, conv_layout="lane_packed")
    c0 = _lookup_counts()
    x = torch.randn(1, 224, 224, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = CNNS["mobilenet_v1"][1](qp, x, quant="logq6", conv_impl="cuda")
    d = {r: v - c0[r] for r, v in _lookup_counts().items()}
    assert d == {"hit_user": 0, "hit_warm": 19, "miss": 0}
    assert len(seen) == 27       # each with the packaged tier's knobs
    assert all(c["splits"] is not None or c["tile"] is not None
               for c in seen)
    assert y.shape == (1, 1000) and bool(torch.isfinite(y).all())


# ------------------------------------------------------------- the card


@pytest.mark.cuda
def test_cuda_autotune_conv2d_records_a_correct_winner(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep times the kernel")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.normal(size=(2, 28, 28, 64)).astype(np.float32),
                        device=dev)
    qt = quantize_tensor(torch.as_tensor(
        rng.normal(size=(1, 1, 64, 128)).astype(np.float32), device=dev))
    kw = dict(stride=2, padding="SAME")
    best = autotune.autotune_conv2d(x, qt.packed, qt.scale, qt.cfg, **kw,
                                    reps=5)
    key = autotune.conv_key(2, 28, 28, 64, 1, 128, cfg=qt.cfg, **kw)
    assert autotune.lookup(key) == best
    y = ops.conv2d(x, qt, impl="cuda", **kw)      # picks the winner up
    want = tlc.log_conv2d_blockwise(x, qt.packed, qt.scale, qt.cfg, **kw)
    assert float((y - want).abs().max()) <= 1e-4 * (
        float(want.abs().max()) + 1)
    torch.cuda.synchronize()
    assert int(tlc._TICKETS[dev.index].abs().sum()) == 0
