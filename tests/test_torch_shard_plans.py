"""The port's plan choice and byte models (`repro_torch.kernels.sharded`)
against the reference's, with no process group: the reference's
`plan_kernel_sharding` runs on `jax.sharding.AbstractMesh`es (no
devices), the port's on a mapping from axis name to size. Also the specs
each plan gives the moments and the per-shard carries, and the identity
in-graph hints of `sharding.rules`."""
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.kernels import sharded as JS
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import sharded as S
from repro_torch.models.layers import _kv_dims
from repro_torch.sharding import rules as R
from torch_threads import share_cores  # noqa: F401,E402

# (axis names, shape)
MESHES = {"2x4": (("data", "model"), (2, 4)),
          "4x2": (("data", "model"), (4, 2)),
          "pod": (("data", "model"), (16, 16)),
          "two-pods": (("pod", "data", "model"), (2, 16, 16)),
          "cp2": (("data", "seq"), (4, 2)),
          "cp4": (("data", "seq"), (2, 4)),
          "tp-cp": (("data", "model", "seq"), (2, 2, 2))}


def _shapes(arch):
    """(hq, hkv, dv) of the config's attention calls: the decode state's
    kv heads (MLA decompresses k, v per query head) and the GQA layer's."""
    cfg = get_config(arch)
    hkv, _ = _kv_dims(cfg)
    return {(cfg.n_heads, hkv, cfg.head_dim),
            (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)}


def _same(port, ref):
    if ref is None:
        assert port is None
        return
    assert port is not None
    assert (port.mode, port.batch, port.tp, port.cp) == (
        ref.mode, ref.batch, ref.tp, ref.cp)
    assert port.head == ref.head and port.feat == ref.feat
    assert port.describe() == ref.describe()
    assert [tuple(s) for s in S._moment_specs(port)] == [
        tuple(s) for s in JS._moment_specs(ref)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_plan_matches_the_reference(arch, mesh):
    axes, shape = MESHES[mesh]
    jmesh, pmesh = AbstractMesh(shape, axes), dict(zip(axes, shape))
    for hq, hkv, dv in _shapes(arch):
        for batch in (1, 2, 3, 32):
            for seq_len in (None, 2, 4096, 4097):
                kw = dict(batch=batch, hq=hq, hkv=hkv, dv=dv,
                          seq_len=seq_len)
                _same(S.plan_kernel_sharding(pmesh, **kw),
                      JS.plan_kernel_sharding(jmesh, **kw))


def test_plan_modes():
    """Heads when kv heads and query heads divide tp, else feature when
    Dv does, else None; seq only at tp = 1 with a seq_len cp divides."""
    tp = {"data": 2, "model": 4}
    assert S.plan_kernel_sharding(tp, batch=2, hq=16, hkv=8, dv=128).mode \
        == "heads"
    assert S.plan_kernel_sharding(tp, batch=2, hq=48, hkv=1, dv=128).mode \
        == "feature"
    assert S.plan_kernel_sharding(tp, batch=2, hq=3, hkv=1, dv=6) is None
    cp = {"data": 2, "seq": 4}
    plan = S.plan_kernel_sharding(cp, batch=2, hq=16, hkv=8, dv=128,
                                  seq_len=4096)
    assert (plan.mode, plan.cp, plan.tp, plan.batch) == ("seq", 4, 1, "data")
    assert S.plan_kernel_sharding(cp, batch=2, hq=16, hkv=8, dv=128).mode \
        == "heads"
    assert S.plan_kernel_sharding(None, batch=2, hq=1, hkv=1, dv=1) is None


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_seq_state_specs_match_the_reference(batch):
    jp = JS.plan_kernel_sharding(AbstractMesh((4, 2), ("data", "seq")),
                                 batch=batch, hq=4, hkv=2, dv=8,
                                 seq_len=64)
    pp = S.plan_kernel_sharding({"data": 4, "seq": 2}, batch=batch, hq=4,
                                hkv=2, dv=8, seq_len=64)
    assert [tuple(s) for s in S._seq_state_specs(pp.batch)] == [
        tuple(s) for s in JS._seq_state_specs(jp.batch)]
    assert S.plan_specs(pp)["q"] == (pp.batch, None, "seq", None)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("cp", [2, 4, 8])
@pytest.mark.parametrize("shape", [
    (2048, 2, 8, 128, 128),       # qwen3-1.7b's layer at B = 2
    (2048, 1, 8, 128, 128),
    (4096, 4, 1, 128, 128),       # granite's MQA
    (1024, 2, 128, 192, 128),     # deepseek-v2's MLA
    (128, 2, 2, 8, 8)])
def test_byte_models_match_the_reference(monkeypatch, shape, cp, p):
    monkeypatch.delenv("REPRO_CP_EXCHANGE", raising=False)
    n, b, hkv, d, dv = shape
    kw = dict(b=b, hkv=hkv, d=d, dv=dv, p=p)
    assert S.cp_carry_bytes(**kw) == JS.cp_carry_bytes(**kw)
    assert S.cp_boundary_model(n=n, cp=cp, **kw) == JS.cp_boundary_model(
        n=n, cp=cp, **kw)
    for forced in ("ring", "allgather", "auto", "RING"):
        monkeypatch.setenv("REPRO_CP_EXCHANGE", forced)
        carry = S.cp_carry_bytes(**kw)
        assert S.pick_cp_exchange(cp, carry) == JS.pick_cp_exchange(cp,
                                                                     carry)


def test_cp_exchange_budget(monkeypatch):
    """qwen3's carry at B = 2 (136.3 MB) is gathered past the 256 MiB
    budget at cp = 2 (ring); at B = 1 (68.2 MB) it is not (allgather)."""
    monkeypatch.delenv("REPRO_CP_EXCHANGE", raising=False)
    b2 = S.cp_carry_bytes(b=2, hkv=8, d=128, dv=128, p=2)
    b1 = S.cp_carry_bytes(b=1, hkv=8, d=128, dv=128, p=2)
    assert round(b2 / 1e6, 1) == 136.3 and round(b1 / 1e6, 1) == 68.2
    assert S.pick_cp_exchange(2, b2) == "ring"
    assert S.pick_cp_exchange(2, b1) == "allgather"
    m = S.cp_boundary_model(n=2048, b=2, hkv=8, d=128, dv=128, p=2, cp=2)
    m4 = S.cp_boundary_model(n=2 ** 20, b=2, hkv=8, d=128, dv=128, p=2,
                             cp=2)
    assert m["carry_bytes_per_boundary"] == m4["carry_bytes_per_boundary"]


def test_in_graph_hints_are_identities():
    """Under local-shard SPMD a rank's tensors already are its shards: the
    reference's layout hints return their input, with or without an
    active mesh."""
    x = torch.randn(2, 4, 8, 16)
    for active in (None, {"data": 2, "model": 4}):
        with R.use_mesh(active):
            assert R.maybe_constraint(x, "data", "model") is x
            assert R.replicate(x, batch_dim=0) is x
            assert R.shard_stacked(x, batch_dim=1, model_dim=-1,
                                   seq_dim=0) is x
            assert R.constrain_kv_cache(x, lead=0) is x


def test_use_mesh_nests():
    assert R.active_mesh() is None and S.nontrivial_mesh() is None
    outer, inner = {"data": 2, "seq": 2}, {"data": 1, "model": 1}
    with R.use_mesh(outer):
        assert R.active_mesh() is outer and S.nontrivial_mesh() is outer
        with R.use_mesh(inner):
            # all axes of size 1: no plan, the single-device launches
            assert R.active_mesh() is inner and S.nontrivial_mesh() is None
        assert R.active_mesh() is outer
    assert R.active_mesh() is None
