"""The port's sharding rules (`repro_torch.models.sharding`, the step
builders' shardings in `repro_torch.launch.steps`, the meshes of
`repro_torch.launch.mesh`) against the JAX package's:

  * for every arch, on the 16×16 and 2×16×16 production meshes (given to
    JAX as an ``AbstractMesh``): `param_specs`, and the sanitized specs of
    the train step's state and batch shardings, the decode step's param,
    cache and batch shardings (M-RoPE positions included) and the prefill
    step's, leaf for leaf; `cache_specs` at each arch's decode shapes;
  * a packed (logq6) leaf: its codes shard by the leaf's axes and its
    scale along the channel dim (JAX's path walk names a packed child by
    its index, so JAX replicates those leaves);
  * `sanitize_spec`, mirroring `tests/test_perf_features.py`;
  * `placements`: a ("pod", "data") dim is Shard on both mesh dims;
  * the production meshes in a child process under the ``fake`` backend
    (JAX's axis names; a world of 1 raises, naming 256).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh as JMesh  # noqa: E402
from jax.sharding import NamedSharding as JNS  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs.base import SHAPES, cell_is_runnable  # noqa: E402
from repro.configs.registry import ARCH_NAMES  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import sharding as jsh  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core.logquant import QuantizedTensor  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _jflat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (P, JNS)))
    return {"/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in path):
            tuple(leaf.spec if isinstance(leaf, JNS) else leaf)
            for path, leaf in leaves}


def _tflat(tree, prefix="") -> dict:
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_tflat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, QuantizedTensor):
        return {**_tflat(tree.packed, prefix + "/0"),
                **_tflat(tree.scale, prefix + "/1")}
    return {prefix: tuple(getattr(tree, "spec", tree))}


@pytest.fixture
def meshes(request):
    shape, axes = MESHES[request.param]
    yield JMesh(shape, axes), tsh.AbstractMesh(shape, axes)
    jsh.set_mesh(None)
    tsh.set_mesh(None)


@pytest.mark.parametrize("meshes", [False, True], indirect=True,
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_equal_jax(arch, meshes):
    jm, tm = meshes
    jcfg, tcfg = jget(arch), tget(arch)
    dp = 16 * (2 if "pod" in jm.axis_names else 1)

    # param_specs (unsanitized) under each package's installed rules
    jsh.set_mesh(jm)
    tsh.set_mesh(tm)
    assert _tflat(tsh.param_specs(tt.abstract_params(tcfg))) == \
        _jflat(jsh.param_specs(jt.abstract_params(jcfg)))

    # train: state (params, AdamW moments, counters) and batch shardings
    _, _, jtr = jsteps.build_train_step(jcfg, "train_4k", jm)
    _, _, ttr = tsteps.build_train_step(tcfg, "train_4k", tm)
    assert _tflat(list(ttr)) == _jflat(jtr)

    # decode: params, cache and batch shardings at each decode shape
    for shape in ("decode_32k", "long_500k"):
        if not cell_is_runnable(arch, shape):
            continue
        _, _, jd = jsteps.build_decode_step(jcfg, shape, jm)
        _, _, td = tsteps.build_decode_step(tcfg, shape, tm)
        assert _tflat(list(td)) == _jflat(jd), shape
        B, S = SHAPES[shape]["global_batch"], SHAPES[shape]["seq_len"]
        assert _tflat(tsh.cache_specs(tt.abstract_cache(tcfg, B, S), B,
                                      dp)) == \
            _jflat(jsh.cache_specs(jt.abstract_cache(jcfg, B, S), B, dp))

    # prefill: params and batch shardings (fp params)
    _, _, jp = jsteps.build_prefill_step(jcfg, "prefill_32k", jm)
    _, _, tp = tsteps.build_prefill_step(tcfg, "prefill_32k", tm)
    assert _tflat(list(tp)) == _jflat(jp)


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b"])
def test_packed_leaves_shard_codes_by_the_leaf_axes(arch):
    """A logq6 leaf: codes [n_rep, K, N] by the leaf's axes, scale
    [n_rep, 1, N] along its channel dim; the fp leaves as JAX's."""
    tm = tsh.AbstractMesh((16, 16), ("data", "model"))
    cfg = dataclasses.replace(tget(arch), quant="logq6")
    try:
        _, _, (psh, _) = tsteps.build_prefill_step(cfg, "prefill_32k", tm)
    finally:
        tsh.set_mesh(None)
    seg = psh["segments"]["seg0"]["l0"]
    col, row = (seg["attn"]["wq"], seg["attn"]["wo"]) if "attn" in seg \
        else (seg["rwkv"]["wr"], seg["rwkv"]["wo"])
    assert isinstance(col, QuantizedTensor)
    assert col.packed.spec == (None, "data", "model")
    assert col.scale.spec == (None, None, "model")
    assert row.packed.spec == (None, "model", "data")
    assert row.scale.spec == (None, None, "data")
    assert psh["embed"]["table"].spec == ("model", "data")


class _FakeMesh:
    shape = {"data": 16, "model": 16}


@pytest.mark.parametrize("spec, shape, want", [
    # divisible stays
    (("model", None), (32, 7), ("model", None)),
    # non-divisible dims drop to None (granite vocab 49155, batch 1)
    (("model", "data"), (49155, 32), (None, "data")),
    ((("data", "model"), None), (1, 8), (None, None)),
    # shorter spec than rank is padded
    (("data",), (16, 8, 4), ("data", None, None)),
])
def test_sanitize_spec_drops_nondivisible(spec, shape, want):
    assert tsh.sanitize_spec(_FakeMesh(), spec, shape) == want
    assert tuple(jsh.sanitize_spec(_FakeMesh(), P(*spec), shape)) == want


def test_placements_shard_pod_major_and_refuse_reuse():
    m = tsh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert tsh.placements(m, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(m, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements(m, (("data", "pod"),))
    with pytest.raises(ValueError, match="used twice"):
        tsh.placements(m, ("model", "model"))


_CHILD = r"""
import json, sys
sys.path.insert(0, {src!r})
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

out = {{}}
for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    m = make_production_mesh(multi_pod=multi, device="cpu")
    out[str(world)] = [list(m.mesh_dim_names), list(m.shape)]
    dist.destroy_process_group()
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
try:
    make_production_mesh(device="cpu")
    out["1"] = "no error"
except RuntimeError as e:
    out["1"] = str(e)
h = make_host_mesh(device="cpu")
out["host"] = [list(h.mesh_dim_names), list(h.shape)]
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_production_meshes_under_the_fake_backend():
    script = _CHILD.format(src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["256"] == [["data", "model"], [16, 16]]
    assert res["512"] == [["pod", "data", "model"], [2, 16, 16]]
    assert "world of 256" in res["1"] and "has 1" in res["1"]
    assert res["host"] == [["data", "model"], [1, 1]]
