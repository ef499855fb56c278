"""The port run sharded: one spawn of 4 gloo ranks on a 2×2 ``("data",
"model")`` mesh (child processes; no process group in the test process),
whose results come back through files, held against the one-process run:

  (a) the forward of four reduced families (gemma3-1b, granite-moe-1b-a400m,
      rwkv6-1.6b, recurrentgemma-2b) on params restored sharded from a
      checkpoint written by the JAX package, within 1e-4·(max|h|+1); every
      rank's gathered output identical; the one-process forward against
      JAX's `transformer.forward` on the same weights;
  (b) JAX's four layout variants (``attn_shard="heads"``, ``"seq"`` with
      ``residual_shard="seq"``, the same with ``sp_style="megatron"``,
      ``gqa_broadcast`` with bf16 accumulation) against the baseline,
      with `test_perf_variants_numerically_equal_baseline`'s 5e-2;
  (c) `build_prefill_step` then two `build_decode_step` calls on packed
      logq6 params and caches placed by the builders' shardings (batch 2:
      the batch sharded; batch 1 for gemma3-1b: the KV cache sharded on
      its sequence), within 8e-3·(max|y|+1) a call;
  (d) one `build_train_step` step (SGD with momentum), ``grad_compress``
      off and on: the updated params within 1e-5 of max|p| a leaf, the
      loss and gradient norm on every rank within 1e-5 relative;
  (e) the sharded forwards issued collectives (`CommDebugMode`);
  (f) `launch.serve.main` on the 4 ranks (the (1, 4) host mesh), and the
      engine on the 2×2 mesh (its batch split, per-row decode offsets
      with it), serve the tokens of the one-process engine;
  (g) `ops.conv2d` on replicated DTensors equals the plain call (JAX's CNN
      has no sharding constraint);
  and the JAX checkpoint restored sharded: every rank's shard is its slice
  of the saved array.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.runtime import checkpoint as jck  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["gemma3-1b", "granite-moe-1b-a400m", "rwkv6-1.6b",
            "recurrentgemma-2b"]
VARIANTS = {"heads": dict(attn_shard="heads"),
            "seq": dict(attn_shard="seq", residual_shard="seq"),
            "megatron": dict(attn_shard="seq", residual_shard="seq",
                             sp_style="megatron"),
            "gqa_bf16": dict(gqa_broadcast=True, attn_acc_dtype="bf16")}
TOKS = np.array([[5, 3, 9, 2, 6, 1, 7, 8], [4, 11, 2, 9, 13, 3, 6, 1]],
                np.int32)

_WORKER = r'''
import dataclasses, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

FAMILIES, VARIANTS = {families!r}, {variants!r}


def run(rank, world, data):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{{data}}/pg",
                            rank=rank, world_size=world)
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs import base
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding, transformer as tt
    from repro_torch.runtime.checkpoint import load_checkpoint
    from repro_torch.serving.quantize import quantize_params
    from repro_torch.training.optimizer import OptimizerConfig, tree_leaves
    from repro_torch.training.train_loop import TrainConfig, init_train_state

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    res0 = time.perf_counter()
    full = sharding.full
    toks = torch.from_numpy(np.load(os.path.join(data, "toks.npy")))
    res, plain = {{"t/start": res0}}, {{}}

    def rel(a, b):
        return float((full(a) - b).abs().max() / (b.abs().max() + 1))

    # (a) + restore + (e)
    for arch in FAMILIES:
        cfg = get_config(arch).reduced()
        tpl = tt.abstract_params(cfg)
        ck = os.path.join(data, "ckpt", arch)
        p, _ = load_checkpoint(ck, tpl, device="cpu")
        sharding.set_mesh(mesh)
        sh = sharding.param_shardings(mesh, tpl)
        placed, _ = load_checkpoint(ck, tpl, shardings=sh)
        err, n_sharded = 0.0, 0
        for a, b, s in zip(tree_leaves(placed), tree_leaves(p),
                           tree_leaves(sh)):
            local = b[sharding.local_slice(b.shape, s)]
            err = max(err, float((a.to_local() - local).abs().max()),
                      float((a.full_tensor() - b).abs().max()))
            n_sharded += any(isinstance(q, Shard) for q in a.placements)
        res[f"restore/{{arch}}"] = (err, n_sharded)
        sharding.set_mesh(None)
        h1, _, _ = tt.forward(p, toks, cfg)
        sharding.set_mesh(mesh)
        with CommDebugMode() as cm:
            hs, _, _ = tt.forward(placed, toks, cfg)
        res[f"a/{{arch}}"] = (h1, full(hs), cm.get_total_counts())
        plain[arch] = (cfg, p, placed, h1)

    res["t/(b)"] = time.perf_counter()
    # (b)
    cfg, p, placed, h1 = plain["gemma3-1b"]
    for name, kw in VARIANTS.items():
        kw = {{k: (torch.bfloat16 if v == "bf16" else v)
              for k, v in kw.items()}}
        hv, _, _ = tt.forward(placed, toks, dataclasses.replace(cfg, **kw))
        res[f"b/{{name}}"] = (h1, full(hv))

    res["t/(c)"] = time.perf_counter()
    # (c)
    for arch, B in [(a, 2) for a in FAMILIES] + [("gemma3-1b", 1)]:
        base.SHAPES["t_prefill"] = dict(seq_len=16, global_batch=B,
                                        step="prefill")
        base.SHAPES["t_decode"] = dict(seq_len=16, global_batch=B,
                                       step="decode")
        cfg = dataclasses.replace(plain[arch][0], quant="logq6")
        packed = quantize_params(plain[arch][1])
        pf, _, (psh, bsh) = steps.build_prefill_step(
            cfg, "t_prefill", mesh, cache_dtype=torch.float32)
        df, _, (_, csh, dsh) = steps.build_decode_step(
            cfg, "t_decode", mesh, cache_dtype=torch.float32)
        sp = sharding.place(packed, psh)
        batch = {{"tokens": toks[:B]}}
        y0, c0 = pf(packed, batch)
        y1, c1 = pf(sp, sharding.place(batch, bsh))
        errs = [rel(y1, y0)]
        leaves = zip(tree_leaves(c1["segments"]),
                     tree_leaves(csh["segments"]))
        placed_ok = all(tuple(a.placements) == s.placements
                        for a, s in leaves)
        for t in range(2):
            nt = {{"tokens": toks[:B, t:t + 1]}}
            y0, c0 = df(packed, c0, nt)
            y1, c1 = df(sp, c1, sharding.place(nt, dsh))
            errs.append(rel(y1, y0))
        res[f"c/{{arch}}/{{B}}"] = (errs, placed_ok, full(y1))

    res["t/(d)"] = time.perf_counter()
    # (d)
    base.SHAPES["t_train"] = dict(seq_len=8, global_batch=4, step="train")
    cfg, p0 = plain["gemma3-1b"][:2]
    g = torch.Generator().manual_seed(0)
    batch = {{"tokens": torch.randint(0, cfg.vocab, (4, 8), generator=g),
             "labels": torch.randint(0, cfg.vocab, (4, 8), generator=g),
             "mask": torch.ones(4, 8)}}
    opt = OptimizerConfig(name="sgd", lr=1e-2, warmup_steps=0,
                          schedule="constant")
    for gc in (False, True):
        fn, _, (ssh, bsh) = steps.build_train_step(
            cfg, "t_train", mesh, grad_compress=gc, opt=opt, xent_chunk=8)
        tcfg = TrainConfig(opt=opt, grad_compress=gc)
        clone = lambda t: {{k: clone(v) for k, v in t.items()}} \
            if isinstance(t, dict) else t.clone()
        s0 = init_train_state(clone(p0), tcfg)
        s1 = sharding.place(init_train_state(clone(p0), tcfg), ssh)
        s0, m0 = fn(s0, batch)
        s1, m1 = fn(s1, sharding.place(batch, bsh))
        errs = [float((full(b).detach() - a).abs().max() / a.abs().max())
                for a, b in zip(tree_leaves(s0["params"]),
                                tree_leaves(s1["params"]))]
        # the step's metrics come back whole (a local partial sum of the
        # loss would differ from rank to rank)
        res[f"d/{{gc}}"] = (max(errs), [float(m0[k]) for k in m0],
                           [float(m1[k]) for k in m1])
    sharding.set_mesh(None)

    # (g): conv2d, replicated on every rank
    from repro_torch.core.logquant import quantize_tensor
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, 8, 4, generator=g)
    qt = quantize_tensor(torch.randn(3, 3, 4, 8, generator=g))
    rep = sharding.replicated
    qd = type(qt)(rep(qt.packed, mesh), rep(qt.scale, mesh), qt.cfg,
                  qt.shape)
    y = ops.conv2d(rep(x, mesh), qd)
    res["g"] = ([p.is_replicate() for p in y.placements], y.to_local(),
                ops.conv2d(x, qt))

    res["t/(f)"] = time.perf_counter()
    # (f): the launcher on the 4 ranks, then one rank's plain engine
    argv = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
            "--requests", "2", "--max-new", "3", "--max-batch", "2"]
    res["f/mesh"] = [r.output for r in serve.main(argv)]
    args = serve.parse_args(argv)
    for name, m in (("f/2x2", mesh), ("f/plain", None)):
        sharding.set_mesh(m)   # 2x2: the batch split, per-row offsets too
        engine = serve.build_engine(args)
        for req in serve.make_requests(args, engine.cfg.vocab):
            engine.submit(req)
        res[name] = [r.output for r in engine.run()]
    sharding.set_mesh(None)

    res["t/end"] = time.perf_counter()
    torch.save(res, os.path.join(data, f"rank{{rank}}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, {src!r})
    mp.spawn(run, args=(4, sys.argv[1]), nprocs=4)
'''


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """JAX checkpoints, then the 4-rank spawn, with JAX's forwards computed
    here while the ranks run."""
    data = tmp_path_factory.mktemp("sharded")
    np.save(data / "toks.npy", TOKS)
    params = {}
    for arch in FAMILIES:
        params[arch] = jt.init_params(jget(arch).reduced(),
                                      jax.random.PRNGKey(3))
        jck.save_checkpoint(str(data / "ckpt" / arch), 0, params[arch])
    script = data / "worker.py"
    script.write_text(_WORKER.format(families=FAMILIES, variants=VARIANTS,
                                     src=str(ROOT / "src")))
    proc = subprocess.Popen([sys.executable, str(script), str(data)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True,
                            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    try:
        want = {arch: np.array(jt.forward(p, jnp.asarray(TOKS),
                                          jget(arch).reduced())[0],
                               np.float32)
                for arch, p in params.items()}
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    ranks = [torch.load(data / f"rank{r}.pt") for r in range(4)]
    return ranks, want


def _rel(got, want):
    return float((got - want).abs().max() / (want.abs().max() + 1))


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_forward_matches_one_process_and_jax(spawn, arch):
    ranks, want = spawn
    h1, hs, _ = ranks[0][f"a/{arch}"]
    assert _rel(hs, h1) < 1e-4
    for r in ranks[1:]:
        assert torch.equal(r[f"a/{arch}"][1], hs)
    assert _rel(h1, torch.from_numpy(want[arch])) < 1e-4


@pytest.mark.parametrize("arch", FAMILIES)
def test_jax_checkpoint_restores_sharded(spawn, arch):
    ranks, _ = spawn
    for r in ranks:
        err, n_sharded = r[f"restore/{arch}"]
        assert err == 0.0 and n_sharded > 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_layout_variants_equal_baseline(spawn, variant):
    ranks, _ = spawn
    h1, hv = ranks[0][f"b/{variant}"]
    np.testing.assert_allclose(hv.numpy(), h1.numpy(), rtol=5e-2, atol=5e-2)
    for r in ranks[1:]:
        assert torch.equal(r[f"b/{variant}"][1], hv)


@pytest.mark.parametrize("arch, batch",
                         [(a, 2) for a in FAMILIES] + [("gemma3-1b", 1)])
def test_prefill_then_decode_on_packed_params(spawn, arch, batch):
    ranks, _ = spawn
    errs, placed_ok, y = ranks[0][f"c/{arch}/{batch}"]
    assert placed_ok
    assert len(errs) == 3 and max(errs) < 8e-3, errs
    for r in ranks[1:]:
        assert torch.equal(r[f"c/{arch}/{batch}"][2], y)


@pytest.mark.parametrize("grad_compress", [False, True])
def test_train_step_matches_one_process(spawn, grad_compress):
    ranks, _ = spawn
    for r in ranks:
        err, metrics0, metrics1 = r[f"d/{grad_compress}"]
        assert err < 1e-5
        np.testing.assert_allclose(metrics1, metrics0, rtol=1e-5)


def test_sharded_forwards_issue_collectives(spawn):
    ranks, _ = spawn
    for arch in FAMILIES:
        assert ranks[0][f"a/{arch}"][2] > 0, arch


def test_conv2d_runs_replicated(spawn):
    ranks, _ = spawn
    for r in ranks:
        placements, y, want = r["g"]
        assert placements == [True, True]
        assert torch.equal(y, want)


def test_serve_launcher_on_four_ranks(spawn):
    ranks, _ = spawn
    for r in ranks:
        assert r["f/mesh"] == r["f/plain"] and len(r["f/mesh"]) == 2
        assert r["f/2x2"] == r["f/plain"]
