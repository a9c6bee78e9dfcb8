"""The port's placement layer against the reference's: the logical axes of
every parameter (`models.param_axes`, the `Builder`'s parallel tree), the
specs of `sharding.rules` (parameters, batch, KV caches, decode states with
the moments' heads and feature modes and the greedy generic leaves), their
DTensor placements, `launch/mesh.py` on a fake process group, the meta
descriptions of a model's inputs and decode state, and the smoke models'
weights, unchanged by the axes.

The reference's rules run on a `jax.sharding.AbstractMesh` (no devices);
the port's on a plain mapping from axis name to size or on a
`DeviceMesh` over torch's single-process fake process group (created and
destroyed by a fixture; no subprocesses).
"""
import dataclasses
import functools
import hashlib

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.attention import AttentionSpec as JSpec
from repro.configs import get_config as jget_config
from repro.models.model import decode_state_specs as jdecode_state_specs
from repro.models.model import init_model as jinit_model
from repro.models.model import input_specs as jinput_specs
from repro.sharding import rules as JR
from repro_torch.attention import AttentionSpec
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import (decode_state_specs, init_model, input_specs,
                                param_axes)
from repro_torch.sharding import rules as R
from torch_threads import share_cores  # noqa: F401,E402

ARCHS = sorted(ARCH_IDS)
# (axis names, shape): one pod, two pods, a small mesh, context parallel
MESHES = {"pod": (("data", "model"), (16, 16)),
          "two-pods": (("pod", "data", "model"), (2, 16, 16)),
          "small": (("data", "model"), (2, 4)),
          "cp4": (("data", "seq"), (64, 4)),
          "two-pods-cp8": (("pod", "data", "seq"), (2, 32, 8))}

# sha256 of each smoke config's parameters (seed 0, CPU; leaves in sorted
# path order, each its path, shape, dtype and bytes), computed on the tree
# before the Builder recorded logical axes: recording them draws nothing
SMOKE_SHA256 = {
    "chameleon-34b":
        "0d3bbe1a52e5cf82e8b6137cc26002c6"
        "c4a7aabd3d5eeec82c3e50b656a08408",
    "deepseek-v2-236b":
        "aee93270063eed4a4a3be7ce60a06029"
        "90bebe2f051c36794f595f400545a614",
    "granite-20b":
        "e6838b4027510ae264298711252a8b1c"
        "abea7232b6cd601530a0f233c8c3c917",
    "jamba-v0.1-52b":
        "778cd4d50eb036c8028442f476558ae3"
        "2db9dfc9238a515609ce37388b164e78",
    "kimi-k2-1t-a32b":
        "bd6f8125d959c8d4a92bab49b511bd7e"
        "766bbc4144ba8f6637ab8bdbae6e4921",
    "llama3-405b":
        "c17d1a4a7231edff045f631c96ab2726"
        "2266568a8131659a9394f49601de78e3",
    "qwen2.5-32b":
        "e4083aa965f3d5c21c247ae336d26176"
        "d79f28824c26b5bcf8ecbb58e53edbe2",
    "qwen3-1.7b":
        "e01c768d1507048bd1256fc8fccfd686"
        "b865fecdd210b39452fa63d6484dba50",
    "whisper-small":
        "34d007efd34bab1e5a5466b65cf54054"
        "4daee6604d6824d6fa8a4659118bef6d",
    "xlstm-1.3b":
        "e49601eb253c61735ac7de19f1a45dd5"
        "78f2216d85df657b118183770257a592",
}


def _jmesh(name):
    axes, shape = MESHES[name]
    return AbstractMesh(shape, axes)


def _mesh(name):
    axes, shape = MESHES[name]
    return dict(zip(axes, shape))


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    """The reference's abstract parameters and their axes (full size)."""
    return jinit_model(jax.random.PRNGKey(0), jget_config(arch),
                       abstract=True)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The port's meta parameters and their axes (full size)."""
    return init_model(get_config(arch), device="meta", with_axes=True)


def _leaves(tree, prefix=""):
    """(path, leaf) pairs of nested dicts in sorted key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def _state_leaves(tree):
    """The leaves of a decode-state tree (of specs or tensors) in
    jax.tree.leaves' order: dict keys sorted, NamedTuple fields in order,
    None legs skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _state_leaves(tree[k])]
    if isinstance(tree, tuple) and not isinstance(tree, R.Spec):
        return [x for v in tree for x in _state_leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_the_reference(arch):
    """Every leaf's logical axes (and shape) of the full config equal the
    reference's `init_model(..., abstract=True)` axes."""
    jshapes, jaxes = _jparams(arch)
    axes = param_axes(get_config(arch))
    ref = _leaves(jax.tree.map(lambda x: x, jaxes,
                               is_leaf=lambda x: isinstance(x, tuple)))
    got = _leaves(axes)
    assert [p for p, _ in got] == [p for p, _ in ref]
    assert got == ref
    shapes = _leaves(_params(arch)[0])
    assert [(p, tuple(t.shape)) for p, t in shapes] == [
        (p, tuple(s.shape)) for p, s in _leaves(jshapes)]
    assert all(t.device.type == "meta" for _, t in shapes)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_the_reference(arch, mesh):
    """`param_shardings` on every leaf of the full config equals the
    reference's on the same mesh, with and without FSDP."""
    jshapes, jaxes = _jparams(arch)
    params, axes = _params(arch)
    for rules, jrules in ((None, None), (R.NO_FSDP_RULES, JR.NO_FSDP_RULES)):
        ref = JR.param_shardings(jaxes, jshapes, _jmesh(mesh), jrules)
        got = R.param_shardings(axes, params, _mesh(mesh), rules)
        ref = [(p, tuple(s.spec)) for p, s in _leaves(ref)]
        assert [(p, tuple(s)) for p, s in _leaves(got)] == ref


def test_spec_for_cases():
    """The reference's own spec cases (tests/test_sharding.py)."""
    m, m3 = _mesh("pod"), _mesh("two-pods")
    assert R.spec_for(("embed", "ff"), (4096, 14336), m) == ("data", "model")
    assert R.spec_for(("embed", "kv_heads", "head_dim"), (4096, 8, 128),
                      m) == ("data", None, None)
    rules = {**R.DEFAULT_RULES, "ff": ("data",)}
    assert R.spec_for(("embed", "ff"), (4096, 4096), m, rules) == (
        "data", None)
    rules = {**R.DEFAULT_RULES, "embed": ("pod", "data")}
    assert R.spec_for(("embed", "ff"), (4096, 14336), m3, rules) == (
        ("pod", "data"), "model")
    assert isinstance(R.spec_for(("embed",), (16,), m), R.Spec)
    assert hash(R.Spec("data", None)) == hash(("data", None))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_spec_matches_the_reference(mesh):
    for b in (1, 2, 8, 16, 32, 64, 256, 512):
        assert tuple(R.batch_spec(_mesh(mesh), batch_size=b)) == tuple(
            JR.batch_spec(_jmesh(mesh), batch_size=b)), b


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_kv_cache_spec_matches_the_reference(mesh):
    """Heads over "model" where they divide it (kv 16, 32, 128), else the
    sequence (kv 8 and MQA's kv 1), batch 1 and 32, a stacked lead axis."""
    for shape, lead in (((32, 8, 4096, 128), 0), ((1, 1, 4096, 128), 0),
                        ((32, 16, 4096, 128), 0), ((1, 128, 1024, 192), 0),
                        ((4, 32, 8, 4096, 128), 1), ((2, 1, 8, 4096), 1),
                        ((32, 8, 100, 64), 0)):
        assert tuple(R.kv_cache_spec(shape, _mesh(mesh), lead=lead)) == \
            tuple(JR.kv_cache_spec(shape, _jmesh(mesh), lead=lead)), shape
    assert R.model_axis_size(_mesh(mesh)) == JR.model_axis_size(
        _jmesh(mesh))
    assert R.model_axis_size(None) == 1


def _state_cases():
    """(config, attention override, batch): the fastmax moments in heads
    mode (deepseek-v2 and kimi-k2: 128 kv heads, llama3: 8 of them on the
    small mesh) and feature mode (qwen3: 8 kv heads on 16; granite's MQA),
    softmax KV caches, the hybrid window beside the moments, the Mamba and
    xLSTM states; batch 32 and 1."""
    cases = [(a, None, b) for a in ARCHS for b in (32, 1)]
    cases += [("qwen3-1.7b", "softmax", 32), ("granite-20b", "softmax", 1),
              ("qwen3-1.7b", "hybrid2-chunked", 8)]
    return cases


@pytest.mark.parametrize("mesh", ["pod", "two-pods", "small", "cp4"])
@pytest.mark.parametrize("arch, attn, batch", _state_cases(),
                         ids=lambda x: str(x))
def test_decode_state_shardings_match_the_reference(arch, attn, batch, mesh):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if attn is not None:
        cfg = dataclasses.replace(cfg, attn=AttentionSpec.parse(attn))
        jcfg = dataclasses.replace(jcfg, attn=JSpec.parse(attn))
    jstate = jdecode_state_specs(jcfg, batch, 4096)
    state = decode_state_specs(cfg, batch, 4096)
    got = _state_leaves(R.decode_state_shardings(state, _mesh(mesh),
                                                 batch=batch))
    ref = [tuple(s.spec) for s in jax.tree.leaves(
        JR.decode_state_shardings(jstate, _jmesh(mesh), batch=batch))]
    assert [tuple(s) for s in got] == ref
    shapes = [tuple(t.shape) for t in _state_leaves(state)]
    assert shapes == [tuple(x.shape) for x in jax.tree.leaves(jstate)]
    # a spec may be shorter than its leaf (the rest replicated: a
    # cache's length is Spec())
    assert len(got) == len(shapes) and all(
        len(s) <= len(t) for s, t in zip(got, shapes))


def test_moments_modes():
    """deepseek-v2's 128 kv heads on model = 16: heads mode; qwen3's 8:
    feature mode (Dv over "model", the g moments replicated over it)."""
    m = _mesh("pod")
    ds = R.decode_state_shardings(
        decode_state_specs(get_config("deepseek-v2-236b"), 32, 64), m,
        batch=32)
    mom = ds["dense_0"].moments
    assert mom.m2 == ("data", "model", None, None, None)
    assert mom.g2 == ("data", "model", None, None)
    qs = R.decode_state_shardings(
        decode_state_specs(get_config("qwen3-1.7b"), 1, 64), m, batch=1)
    mom = qs["blocks_0"].moments
    assert mom.m2 == (None, None, None, None, None, "model")
    assert mom.g1 == (None, None, None, None)
    assert qs["blocks_0"].kv is None


def test_placements():
    from torch.distributed.tensor import Replicate, Shard

    m = _mesh("pod")
    assert R.to_placements(R.Spec("data", "model"), m) == (Shard(0),
                                                          Shard(1))
    assert R.to_placements(R.Spec(None, "model", None), m) == (Replicate(),
                                                              Shard(1))
    assert R.to_placements(R.Spec(("data", "model"), None), m) == (
        Shard(0), Shard(0))
    assert R.to_placements(R.Spec(), m) == (Replicate(), Replicate())
    m3 = _mesh("two-pods")
    assert R.to_placements(R.Spec(("pod", "data"), "model"), m3) == (
        Shard(0), Shard(0), Shard(1))
    # the spec's order against the mesh's: the mesh dim processed first
    # splits within the 16 parts of the more major "model"
    from torch.distributed.tensor.placement_types import _StridedShard
    assert R.to_placements(R.Spec(None, ("model", "data")), m) == (
        _StridedShard(1, split_factor=16), Shard(1))
    with pytest.raises(ValueError, match=r"blocks_0/h: .* not in the mesh"):
        R.to_placements(R.Spec(None, ("model", "seq")), m,
                        name="blocks_0/h")


def _order_conflicts(tree, mesh):
    out = []
    for spec in _state_leaves(tree):
        try:
            R.to_placements(spec, mesh)
        except ValueError:
            out.append(tuple(spec))
    return out


def test_reference_specs_that_dtensor_cannot_place():
    """The reference's generic decode-state leaves (Mamba, xLSTM) take dim
    0 as the batch, which on a stacked state is the layer axis: the batch
    stays unsharded and the last dim, taking "model" first, then takes
    ("model", "data") wherever 256 divides it, against the mesh's order.
    DTensor's `Shard` splits a dim in mesh order only; the port places
    these leaves with `_StridedShard` (`test_strided_shards_hold_the_
    reference_chunks` checks the chunks). On one pod that is every Mamba
    conv buffer [4, B, 3, 8192] of jamba and the mLSTM c, n and sLSTM
    leaves of xlstm-1.3b, at batch 1 and 32; no other state leaf, and no
    parameter spec (its rules' order is the mesh's). Every one of them
    now places."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    m = _mesh("pod")
    hits = {}
    for arch in ARCHS:
        for batch in (1, 32):
            st = decode_state_specs(get_config(arch), batch, 4096)
            specs = R.decode_state_shardings(st, m, batch=batch)
            for spec, leaf in zip(_state_leaves(specs), _state_leaves(st)):
                placed = R.to_placements(spec, m)
                if any(isinstance(x, _StridedShard) for x in placed):
                    hits.setdefault((arch, batch), set()).add(
                        (tuple(leaf.shape), tuple(spec)))
                    last = leaf.dim() - 1
                    assert placed == (_StridedShard(last, split_factor=16),
                                      Shard(last))
        params, axes = _params(arch)
        for _, spec in _leaves(R.param_shardings(axes, params, m)):
            assert not any(isinstance(x, _StridedShard)
                           for x in R.to_placements(spec, m))
    assert set(hits) == {(a, b) for a in ("jamba-v0.1-52b", "xlstm-1.3b")
                         for b in (1, 32)}
    assert hits[("jamba-v0.1-52b", 1)] == {
        ((4, 1, 3, 8192), (None, None, None, ("model", "data")))}
    assert all(spec[-1] == ("model", "data")
               for v in hits.values() for _, spec in v)


@pytest.fixture
def fake_group():
    """A single-process fake process group of a given world size,
    destroyed on teardown."""
    def start(world_size):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world_size)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("kw, world, axes, shape", [
    ({}, 256, ("data", "model"), (16, 16)),
    ({"multi_pod": True}, 512, ("pod", "data", "model"), (2, 16, 16)),
    ({"cp": 4}, 256, ("data", "seq"), (64, 4)),
    ({"multi_pod": True, "cp": 8}, 512, ("pod", "data", "seq"), (2, 32, 8))])
def test_production_mesh(fake_group, kw, world, axes, shape):
    fake_group(world)
    mesh = make_production_mesh(**kw)
    assert mesh.mesh_dim_names == axes and tuple(mesh.shape) == shape
    assert mesh.device_type == "cuda"
    assert R.mesh_axes(mesh) == dict(zip(axes, shape))


def test_mesh_refusals(fake_group):
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_production_mesh()
    fake_group(128)
    with pytest.raises(ValueError, match="needs 256 ranks, the process "
                                         "group has 128"):
        make_production_mesh()
    with pytest.raises(ValueError, match="must divide"):
        make_production_mesh(cp=3)


def test_specs_on_a_device_mesh(fake_group):
    """The rules take a DeviceMesh as they take a mapping; qwen3's params
    placed on a (2, 4) test mesh."""
    fake_group(8)
    mesh = make_test_mesh((2, 4), ("data", "model"))
    assert mesh.device_type == "cpu"
    params, axes = _params("qwen3-1.7b")
    on_mesh = R.param_shardings(axes, params, mesh)
    assert on_mesh == R.param_shardings(axes, params, _mesh("small"))
    wq = on_mesh["blocks_0"]["mixer"]["wq"]
    assert tuple(wq) == (None, "data", "model", None)
    from torch.distributed.tensor import Replicate, Shard
    assert R.to_placements(wq, mesh) == (Shard(1), Shard(2))
    assert R.to_placements(on_mesh["final_norm"]["scale"], mesh) == (
        Shard(0), Replicate())


@pytest.mark.parametrize("spec", [("model", "data"), ("data", "model"),
                                  ("model",), ("data",)])
@pytest.mark.parametrize("axes, shape", [
    (("data", "model"), (2, 4)),
    (("data", "model"), (4, 2)),
    (("pod", "data", "model"), (2, 2, 2))])
def test_strided_shards_hold_the_reference_chunks(fake_group, axes, shape,
                                                  spec):
    """A rank's local chunk under `to_placements` is the PartitionSpec
    rule's, the first named axis the major one: for ("model", "data") the
    rank at (data = i, model = j) holds chunk j·|data| + i. Checked at
    every rank of the mesh (one fake process group per rank), against
    DTensor's own local shape and offset and `sharded.shard_local`."""
    import math

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.kernels.sharded import shard_local

    sizes = dict(zip(axes, shape))
    world, n = math.prod(shape), 3 * math.prod(shape)
    x = torch.arange(n)
    chunks = math.prod(sizes[a] for a in spec)
    for rank in range(world):
        fake_group(world)
        dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        at = dict(zip(axes, mesh.get_coordinate()))
        idx = 0
        for a in spec:
            idx = idx * sizes[a] + at[a]
        placed = R.to_placements(R.Spec(spec), mesh)
        size, off = compute_local_shape_and_global_offset((n,), mesh,
                                                          placed)
        assert (size, off) == ((n // chunks,), (idx * (n // chunks),)), (
            rank, at)
        assert torch.equal(shard_local(x, R.Spec(spec), mesh),
                           x[off[0]:off[0] + size[0]])


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_decode_state_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for kind in ("train", "decode"):
        got = input_specs(cfg, global_batch=8, seq_len=64, kind=kind)
        ref = jinput_specs(jcfg, global_batch=8, seq_len=64, kind=kind)
        assert sorted(got) == sorted(ref)
        for k, x in ref.items():
            assert tuple(got[k].shape) == tuple(x.shape)
            assert got[k].device.type == "meta"
            assert str(got[k].dtype).split(".")[-1] == str(x.dtype), k
    with pytest.raises(ValueError):
        input_specs(cfg, global_batch=8, seq_len=64, kind="eval")
    state = decode_state_specs(cfg, 2, 128)
    jstate = jdecode_state_specs(jcfg, 2, 128)
    leaves, ref = _state_leaves(state), jax.tree.leaves(jstate)
    assert [tuple(t.shape) for t in leaves] == [tuple(x.shape) for x in ref]
    assert all(t.device.type == "meta" for t in leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_weights_are_unchanged(arch):
    """Recording the axes draws nothing: each smoke model's parameters
    hash as before it, bit for bit."""
    params = init_model(get_smoke_config(arch), seed=0, device="cpu")
    h = hashlib.sha256()
    for name, t in _leaves(params):
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        h.update(t.detach().contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == SMOKE_SHA256[arch]
    axes = init_model(get_smoke_config(arch), seed=0, device="cpu",
                      with_axes=True)[1]
    assert [p for p, _ in _leaves(axes)] == [p for p, _ in _leaves(params)]
