"""The port's dry run and perf harness (`repro_torch.launch.dryrun`,
`repro_torch.launch.perf`) against the JAX package's, and the repairs of
the sharded path that the production meshes needed.

Every process group, and everything of JAX's ``dryrun``/``perf`` (which set
``XLA_FLAGS`` when imported), runs in child processes, started together
by one fixture:

  * JAX: `repro.launch.dryrun._compile` and its unroll-diff accounting of
    a reduced gemma-2b on a (2, 4) mesh of 8 host devices, for train_4k,
    prefill_32k and decode_32k; `perf.VARIANTS`' field changes; one
    `perf.run_variant` row;
  * the port under a ``fake`` group of 8 ranks: `dryrun.run_cell` for the
    same cells on a (2, 4) mesh (and decode_32k on (2, 1, 4)), written to a
    directory that `analysis.report` and `analysis.roofline` render; the
    count at 1, 2 and 4 layers; `perf.run_variant`; the mask-free
    `write_rows` on ``meta`` shards; the prefill cache on the params'
    device, and a prefill's temporaries against its global cache;
  * the port on 4 gloo ranks of a (1, 4) mesh: a config whose head counts
    (6 query, 2 KV) the ``model`` axis does not divide, held against the
    one-process run computed here; on a 2×2 mesh, an MoE train step with
    its groups split over ``data``, held against the same step on plain
    tensors.

Both decode records take an fp32 cache (`build_decode_step(cache_dtype=)`
patched into `build_step` on both sides): with a bf16 cache XLA's CPU
backend converts the whole cache to fp32 and counts every converted
element as a FLOP, about 9× the port's count of that cell, where the
card's attention kernel reads bf16 and converts in registers.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
pytest.importorskip("jax")

from repro.analysis.roofline import collective_bytes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPES3 = ("train_4k", "prefill_32k", "decode_32k")
# the reduced cell: every dim the (2, 4) mesh divides; a 4096-key block
# divides every sequence (a block past the sequence pads its keys)
REDUCED = dict(n_heads=4, n_kv_heads=4, attn_block_k=4096)
# (port − JAX) / JAX of cost_true.flops as measured, both counts exact
# functions of the shapes: train_4k −0.51 %, prefill_32k −4.87 %,
# decode_32k −4.43 %
FLOPS_RTOL = 0.06

_JAX = r'''
import dataclasses, json, sys, tempfile
from repro.launch import dryrun as jd       # sets XLA_FLAGS first
from repro.launch import perf as jp
from repro.launch import steps as js
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.analysis.roofline import collective_bytes, model_flops_for
from repro.configs.base import SHAPES
from repro.configs.registry import get_config

REDUCED = {reduced!r}
cfg = get_config("gemma-2b").reduced(**REDUCED)
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
build = js.build_step
jd.build_step = lambda c, s, m, **k: (
    ("decode", js.build_decode_step(c, s, m, cache_dtype=jnp.float32))
    if SHAPES[s]["step"] == "decode" else build(c, s, m, **k))
out = {{"cells": {{}}}}
for shape in {shapes!r}:
    kind, comp = jd._compile(cfg, shape, mesh)
    mem = jd._memory(comp)
    acct = dataclasses.replace(cfg, attn_block_k=SHAPES[shape]["seq_len"],
                               scan_unroll=1)
    _, ca = jd._compile(acct, shape, mesh, donate=False)
    cb = jd._compile(dataclasses.replace(acct, scan_unroll=2), shape, mesh,
                     donate=False)[1]
    a, b = jd._plain_cost(ca), jd._plain_cost(cb)
    k = jd._main_seg_reps(cfg) - 1
    out["cells"][shape] = dict(
        memory=mem, model_flops=model_flops_for(cfg, SHAPES[shape]),
        flops=a["flops"] + k * (b["flops"] - a["flops"]),
        collectives=collective_bytes(comp.as_text()))

base = get_config("gemma-2b")
def norm(v):
    return "bfloat16" if "bfloat16" in str(v) else repr(v)
out["variants"] = {{
    name: {{f.name: norm(getattr(fn(base), f.name))
           for f in dataclasses.fields(base)
           if getattr(fn(base), f.name) != getattr(base, f.name)}}
    for name, fn in jp.VARIANTS.items()}}
jp.get_config = lambda a: get_config(a).reduced(**REDUCED)
jp.make_production_mesh = lambda: mesh
with tempfile.TemporaryDirectory() as tmp:
    rec = jp.run_variant("gemma-2b", "decode_32k", "baseline", out_dir=tmp)
out["row"] = {{k: sorted(v) if isinstance(v, dict) and k != "coll_by_type"
              else type(v).__name__ for k, v in rec.items()}}
json.dump(out, open(sys.argv[1], "w"))
'''

_PORT = r'''
import dataclasses, io, json, os, sys, contextlib
import torch
torch.set_num_threads(1)
from repro_torch.analysis import report, roofline
from repro_torch.configs import base
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as dr, perf, steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import sharding, transformer

REDUCED = {reduced!r}
out_dir, res_path = sys.argv[1], sys.argv[2]
res = {{}}
build = steps.build_step
dr.build_step = lambda c, s, m, **k: (
    ("decode", steps.build_decode_step(c, s, m, cache_dtype=torch.float32))
    if base.SHAPES[s]["step"] == "decode" else build(c, s, m, **k))
dr.get_config = perf.get_config = \
    lambda a: get_config(a).reduced(**REDUCED)
real_group = dr.fake_group
dr.fake_group = perf.fake_group = lambda world: real_group(8)
dr.make_production_mesh = perf.make_production_mesh = \
    lambda multi_pod=False, device=None: make_mesh(
        (2, 1, 4) if multi_pod else (2, 4),
        ("pod", "data", "model") if multi_pod else ("data", "model"),
        device=device)

with real_group(8):
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    # the count is linear in depth
    base.SHAPES["t_train"] = dict(seq_len=32, global_batch=8, step="train")
    res["depth"] = {{}}
    for n in (1, 2, 4):
        cfg = get_config("gemma-2b").reduced(**REDUCED, n_layers=n)
        res["depth"][n] = dr._compile(cfg, "t_train", mesh)[1].flops

    # write_rows with the batch split over data, on meta shards
    from torch.distributed.tensor import Shard
    B, S = 4, 16
    cache = sharding.place(
        {{"k": torch.empty((B, S, 2, 16), device="meta")}},
        {{"k": sharding.NamedSharding(mesh, ("data", None, None, None))}})
    k = cache["k"]
    try:
        sharding.write_rows(k, torch.arange(B, device="meta"),
                            torch.full((B,), 5, device="meta"),
                            torch.empty((B, 2, 16), device="meta"))
        pos = torch.arange(4, 12, device="meta")
        sharding.write_rows(k, torch.arange(B, device="meta")[:, None]
                            .expand(B, 8), pos[None].expand(B, 8),
                            torch.empty((B, 8, 2, 16), device="meta"))
        res["write_rows"] = [str(p) for p in k.placements] + [
            str(k.to_local().device), list(k.to_local().shape)]
    except Exception as e:
        res["write_rows"] = f"{{type(e).__name__}}: {{e}}"

    # the prefill cache on the params' device (meta params, CPU mesh)
    base.SHAPES["t_prefill"] = dict(seq_len=32, global_batch=4,
                                    step="prefill")
    cfg = get_config("recurrentgemma-2b").reduced()
    fn, args, shs = steps.build_prefill_step(cfg, "t_prefill", mesh)
    args = [sharding.place(a, s) for a, s in zip(args, shs)]
    try:
        _, cache = fn(*args)
        res["prefill_cache"] = sorted({{str(t.device)
                                       for t in dr._tensors(cache)}})
    except Exception as e:
        res["prefill_cache"] = f"{{type(e).__name__}}: {{e}}"

    # a prefill cell whose cache outweighs its activations: 8 layers
    base.SHAPES["t_prefill_cache"] = dict(seq_len=2048, global_batch=8,
                                          step="prefill")
    cfg = get_config("gemma-2b").reduced(**REDUCED, n_layers=8)
    cache = transformer.abstract_cache(cfg, 8, 2048)
    res["prefill_memory"] = dict(
        dr._compile(cfg, "t_prefill_cache", mesh)[1].memory,
        global_cache_bytes=sum(t.numel() * t.element_size()
                               for t in dr._tensors(cache)))
json.dump(res, open(res_path, "w"))
# records, and the two renderers on their directory
for shape in {shapes!r}:
    dr.run_cell("gemma-2b", shape, multi_pod=False, out_dir=out_dir)
dr.run_cell("gemma-2b", "decode_32k", multi_pod=True, out_dir=out_dir)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    report.main(["--dir", out_dir])
res["report"] = buf.getvalue()
res["rooflines"] = len([r for r in map(roofline.from_record,
                                       roofline.load_records(out_dir))
                        if r.mesh == "single"])
res["t_collective"] = {{
    rec["shape"]: (roofline.from_record(rec).t_collective,
                   rec["cost_true"]["collective_bytes"])
    for rec in roofline.load_records(out_dir) if rec["mesh"] == "single"}}
res["row"] = {{k: sorted(v) if isinstance(v, dict) and k != "coll_by_type"
              else type(v).__name__ for k, v in perf.run_variant(
                  "gemma-2b", "decode_32k", "baseline",
                  out_dir=os.path.join(out_dir, "perf")).items()}}

json.dump(res, open(res_path, "w"))
'''

_GLOO = r'''
import os, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

UNEVEN = {uneven!r}


def run(rank, world, data):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{{data}}/pg",
                            rank=rank, world_size=world)
    from repro_torch.configs import base
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding, transformer as tt
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    cfg = get_config("gemma-2b").reduced(**UNEVEN)
    p = tt.init_params(cfg, 7, device="cpu")
    toks = torch.load(os.path.join(data, "toks.pt"))
    sharding.set_mesh(mesh)
    placed = sharding.place(p, sharding.param_shardings(mesh, p))
    res = {{}}

    def check(name, fn):
        try:
            res[name] = fn()
        except Exception as e:
            res[name] = f"{{type(e).__name__}}: {{e}}"

    check("forward",
          lambda: sharding.full(tt.forward(placed, toks, cfg)[0]))
    B, T = toks.shape
    base.SHAPES["u_prefill"] = dict(seq_len=16, global_batch=B,
                                    step="prefill")
    base.SHAPES["u_decode"] = dict(seq_len=16, global_batch=B, step="decode")

    def decode():
        pf, _, (_, bsh) = steps.build_prefill_step(cfg, "u_prefill", mesh)
        df, _, (_, _, dsh) = steps.build_decode_step(cfg, "u_decode", mesh)
        _, cache = pf(placed, sharding.place({{"tokens": toks}}, bsh))
        return sharding.full(df(placed, cache, sharding.place(
            {{"tokens": toks[:, :1]}}, dsh))[0])
    check("decode", decode)

    # an MoE train step with its groups split over data (8-token groups)
    from repro_torch.models import moe
    from repro_torch.training.optimizer import OptimizerConfig, tree_leaves
    from repro_torch.training.train_loop import TrainConfig, init_train_state
    moe.DEFAULT_GROUP = 8
    mesh2 = make_mesh((2, 2), ("data", "model"), device="cpu")
    cfg = get_config("granite-moe-1b-a400m").reduced()
    base.SHAPES["u_train"] = dict(seq_len=8, global_batch=4, step="train")
    g = torch.Generator().manual_seed(0)
    batch = {{"tokens": torch.randint(0, cfg.vocab, (4, 8), generator=g),
             "labels": torch.randint(0, cfg.vocab, (4, 8), generator=g),
             "mask": torch.ones(4, 8)}}
    opt = OptimizerConfig(name="sgd", lr=1e-2, warmup_steps=0,
                          schedule="constant")
    fn, _, (ssh, bsh) = steps.build_train_step(cfg, "u_train", mesh2,
                                               opt=opt, xent_chunk=8)
    p = tt.init_params(cfg, 7, device="cpu")
    tcfg = TrainConfig(opt=opt)
    clone = lambda t: {{k: clone(v) for k, v in t.items()}} \
        if isinstance(t, dict) else t.clone()

    def moe_train():
        s0, _ = fn(init_train_state(clone(p), tcfg), batch)
        s1, _ = fn(sharding.place(init_train_state(clone(p), tcfg), ssh),
                   sharding.place(batch, bsh))
        return max(float((sharding.full(b).detach() - a).abs().max()
                         / a.abs().max()) for a, b in
                   zip(tree_leaves(s0["params"]), tree_leaves(s1["params"])))
    check("moe_train", moe_train)
    sharding.set_mesh(None)
    torch.save(res, os.path.join(data, f"rank{{rank}}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, {src!r})
    mp.spawn(run, args=(4, sys.argv[1]), nprocs=4)
'''
UNEVEN = dict(n_heads=6, n_kv_heads=2)
TOKS = [[5, 3, 9, 2, 6, 1, 7, 8], [4, 11, 2, 9, 13, 3, 6, 1]]


def _start(script: str, path: Path, *args) -> subprocess.Popen:
    path.write_text(script)
    return subprocess.Popen(
        [sys.executable, str(path), *map(str, args)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu",
                 PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}"
                            f"{os.environ.get('PYTHONPATH', '')}"))


def _wait(proc, timeout=300) -> str:
    """The child's error output if it failed, else ""."""
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return err[-4000:] if proc.returncode else ""


def _load(path):
    return json.loads(path.read_text()) if path.exists() else {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three children, started together; the one-process run of the
    uneven-heads config computed here meanwhile."""
    tmp = tmp_path_factory.mktemp("dryrun")
    torch.save(torch.tensor(TOKS), tmp / "toks.pt")
    procs = [
        _start(_JAX.format(reduced=REDUCED, shapes=SHAPES3),
               tmp / "jax_child.py", tmp / "jax.json"),
        _start(_PORT.format(reduced=REDUCED, shapes=SHAPES3),
               tmp / "port_child.py", tmp / "records", tmp / "port.json"),
        _start(_GLOO.format(uneven=UNEVEN, src=str(ROOT / "src")),
               tmp / "gloo_child.py", tmp)]
    try:
        from repro_torch.configs.registry import get_config
        from repro_torch.models import transformer as tt
        cfg = get_config("gemma-2b").reduced(**UNEVEN)
        p = tt.init_params(cfg, 7, device="cpu")
        toks = torch.tensor(TOKS)
        want = {"forward": tt.forward(p, toks, cfg)[0]}
        cache = tt.init_cache(cfg, len(TOKS), 16, device="cpu")
        _, cache = tt.prefill(p, toks, cfg, cache)
        want["decode"] = tt.decode_step(p, toks[:, :1], cfg, cache)[0]
        errs = [_wait(proc) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        from repro_torch.models import sharding
        sharding.set_mesh(None)
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(4)
             if (tmp / f"rank{r}.pt").exists()]
    return {"jax": _load(tmp / "jax.json"), "port": _load(tmp / "port.json"),
            "records": tmp / "records", "gloo": (ranks, want),
            "errors": dict(zip(("jax", "port", "gloo"), errs))}


@pytest.mark.parametrize("child", ["jax", "port", "gloo"])
def test_child_runs_to_its_end(runs, child):
    assert not runs["errors"][child], runs["errors"][child]


def _record(runs, shape, mesh="single"):
    path = runs["records"] / f"gemma-2b__{shape}__{mesh}.json"
    return json.loads(path.read_text())


# ---------------------------------------------------------------------------
# the wire bytes, against JAX's HLO accounting
# ---------------------------------------------------------------------------

HLO = {
    "all-gather": ("%ag = bf16[16,4096]{1,0} all-gather(bf16[1,4096]{1,0} "
                   "%p0), replica_groups=[16,16]<=[256], dimensions={0}",
                   16 * 4096 * 2, 16),
    "all-reduce": ("%ar = f32[1024,8]{1,0} all-reduce(f32[1024,8]{1,0} %p1),"
                   " replica_groups=[16,16]<=[256], to_apply=%add",
                   1024 * 8 * 4, 16),
    "reduce-scatter": ("%rs = f32[64,128]{1,0} reduce-scatter(f32[1024,128]"
                       "{1,0} %p2), replica_groups=[16,16]<=[256], "
                       "dimensions={0}, to_apply=%add", 64 * 128 * 4, 16),
    "all-to-all": ("%a2a = (f32[4,8]{1,0}, f32[4,8]{1,0}) all-to-all(f32[4,8]"
                   "{1,0} %p3, f32[4,8]{1,0} %p4), replica_groups={{0,1}}",
                   2 * 4 * 8 * 4, 2),
    "collective-permute": ("%cp = bf16[2,3]{1,0} collective-permute(bf16[2,3]"
                           "{1,0} %p5), source_target_pairs={{0,1},{1,0}}",
                           2 * 3 * 2, 2),
}


@pytest.mark.parametrize("op", sorted(HLO))
def test_wire_bytes_equal_jax(op):
    line, result_bytes, group = HLO[op]
    want = collective_bytes(line)
    assert want["counts"] == {op: 1}
    assert dryrun.wire_bytes(op, result_bytes, group) == want["total"]


def test_import_starts_nothing():
    """Importing the dry run and the harness sets no XLA flag and starts no
    process group (JAX's set ``XLA_FLAGS`` at import)."""
    from repro_torch.launch import perf  # noqa: F401
    assert not torch.distributed.is_initialized()
    assert "xla_force_host_platform_device_count=512" not in \
        os.environ.get("XLA_FLAGS", "")


# ---------------------------------------------------------------------------
# the records against JAX's, on the reduced cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES3)
def test_argument_bytes_equal_jax(runs, shape):
    got = _record(runs, shape)["memory"]["argument_bytes"]
    assert got == runs["jax"]["cells"][shape]["memory"]["argument_bytes"]


@pytest.mark.parametrize("shape", SHAPES3)
def test_model_flops_equal_jax(runs, shape):
    assert _record(runs, shape)["model_flops"] == \
        runs["jax"]["cells"][shape]["model_flops"]


@pytest.mark.parametrize("shape", SHAPES3)
def test_flops_within_tolerance_of_jax(runs, shape):
    got = _record(runs, shape)["cost_true"]["flops"]
    want = runs["jax"]["cells"][shape]["flops"]
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)


@pytest.mark.parametrize("shape", SHAPES3)
def test_record_schema_is_jaxs(runs, shape):
    rec = _record(runs, shape)
    assert "error" not in rec
    for key in ("arch", "shape", "mesh", "chips", "model_flops", "params",
                "active_params", "step_kind", "memory",
                "collectives_prod_once", "cost_prod_once", "cost_true",
                "cost_acct_u1", "cost_acct_u2", "n_rep_main_segment",
                "timings"):
        assert key in rec, key
    assert set(rec["memory"]) == set(
        runs["jax"]["cells"][shape]["memory"])
    assert set(rec["collectives_prod_once"]) == {"total", "by_type",
                                                 "counts"}
    assert rec["cost_acct_u1"]["flops"] == rec["cost_true"]["flops"] == \
        rec["cost_acct_u2"]["flops"]
    assert rec["cost_acct_u1"]["coll_by_type"] == \
        rec["collectives_prod_once"]["by_type"]
    assert 0 < rec["peak_rss_bytes"] < 8 * 2**30


def test_multi_pod_record(runs):
    rec = _record(runs, "decode_32k", "multi")
    assert "error" not in rec and rec["chips"] == 512
    assert rec["memory"]["argument_bytes"] > 0


def test_decode_aliases_the_cache_and_train_the_state(runs):
    """The in-place outputs are the arguments' own storage (JAX's
    donation): the decode cache, the train state."""
    dec = _record(runs, "decode_32k")["memory"]
    assert dec["alias_bytes"] >= 0.99 * dec["argument_bytes"] - 2**20
    tr = _record(runs, "train_4k")["memory"]
    assert tr["alias_bytes"] > 0 and tr["output_bytes"] >= tr["alias_bytes"]
    pre = _record(runs, "prefill_32k")["memory"]
    assert pre["alias_bytes"] == 0 and pre["output_bytes"] > 0


def test_count_is_linear_in_depth(runs):
    f = {int(k): v for k, v in runs["port"]["depth"].items()}
    assert f[4] - f[2] == 2 * (f[2] - f[1]) and f[2] > f[1]


# ---------------------------------------------------------------------------
# perf.py and the renderers
# ---------------------------------------------------------------------------


def test_variant_names_equal_jax(runs):
    from repro_torch.launch import perf
    assert list(perf.VARIANTS) == list(runs["jax"]["variants"])


@pytest.mark.parametrize("name", [
    "baseline", "heads_tp", "attn_bf16", "gqa_bcast", "heads+bf16",
    "heads+bf16+bcast", "logq6", "heads+bf16+logq6", "block2048",
    "block4096", "noremat", "heads+bf16+noremat", "seq_tp", "seq_tp+res",
    "seq_tp+res+bf16", "seq_tp+res+bf16+bcast", "heads+bcast",
    "heads+bcast+logq6", "bcast+logq6", "params_bf16",
    "seq+all+params_bf16", "megatron_sp", "megatron_sp+heads"])
def test_variant_changes_equal_jax(runs, name):
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import perf
    base = get_config("gemma-2b")
    cfg = perf.VARIANTS[name](base)

    def norm(v):
        return "bfloat16" if "bfloat16" in str(v) else repr(v)
    got = {f.name: norm(getattr(cfg, f.name))
           for f in dataclasses.fields(base)
           if getattr(cfg, f.name) != getattr(base, f.name)}
    assert got == runs["jax"]["variants"][name]


def test_run_variant_row_has_jaxs_keys(runs):
    assert runs["port"]["row"] == runs["jax"]["row"]


def test_report_renders_the_records(runs):
    text = runs["port"]["report"]
    assert text.count("| gemma-2b |") >= 2 * len(SHAPES3)
    assert "FAIL" not in text
    assert runs["port"]["rooflines"] == len(SHAPES3)


def test_roofline_collective_term_where_collectives_counted(runs):
    for shape, (t_coll, coll) in runs["port"]["t_collective"].items():
        assert coll > 0 and t_coll > 0, shape


# ---------------------------------------------------------------------------
# the repairs of the sharded path
# ---------------------------------------------------------------------------


def _rel(got, want):
    return float((got - want).abs().max() / (want.abs().max() + 1))


def test_uneven_heads_forward_matches_one_process(runs):
    """6 query and 2 KV heads on a 4-way ``model`` axis: each rank's
    forward within 1e-4·(max|h|+1) of the one-process run."""
    ranks, want = runs["gloo"]
    assert len(ranks) == 4, runs["errors"]["gloo"]
    for r in ranks:
        assert torch.is_tensor(r["forward"]), r["forward"]
        assert _rel(r["forward"], want["forward"]) < 1e-4


def test_uneven_heads_decode_matches_one_process(runs):
    """The prefill and one decode step on the same mesh, within
    8e-3·(max|y|+1) of the one-process steps."""
    ranks, want = runs["gloo"]
    assert len(ranks) == 4, runs["errors"]["gloo"]
    for r in ranks:
        assert torch.is_tensor(r["decode"]), r["decode"]
        assert _rel(r["decode"], want["decode"]) < 8e-3


def test_moe_train_step_with_split_groups_matches_one_process(runs):
    """granite-moe's expert FFNs on each rank's groups (`moe._experts`):
    one SGD step on a 2×2 mesh with the groups split over ``data``, every
    updated param within 1e-5 of max|p| of the one-process step (the
    weights' gradients are partial sums over the groups' split)."""
    ranks, _ = runs["gloo"]
    assert len(ranks) == 4, runs["errors"]["gloo"]
    for r in ranks:
        assert isinstance(r["moe_train"], float) and \
            r["moe_train"] < 1e-5, r["moe_train"]


def test_write_rows_on_meta_shards(runs):
    """The decode and prefill writes with the batch split over ``data`` of
    a (2, 4) mesh, on ``meta`` shards: no mask index, no host sync."""
    assert runs["port"]["write_rows"] == [
        "S(0)", "R", "meta", [2, 16, 2, 16]], runs["port"]["write_rows"]


def test_prefill_cache_on_the_params_device(runs):
    """Meta params on a CPU mesh make a meta cache."""
    assert runs["port"]["prefill_cache"] == ["meta"], \
        runs["port"]["prefill_cache"]


def test_prefill_builds_only_the_ranks_cache_shard(runs):
    """On a (2, 4) mesh a rank's prefill holds less than the global cache
    in temporaries: each rank makes its own shard of the cache, where a
    global cache made and then sliced would count in full."""
    mem = runs["port"]["prefill_memory"]
    assert mem["temp_bytes"] < mem["global_cache_bytes"], mem
