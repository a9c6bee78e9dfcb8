"""Port parity of the MLA attention layer (deepseek-v2's projections:
q at qk_nope_dim + qk_rope_dim per head, k and v decompressed per query
head from a kv_lora_rank latent, RoPE on the rope part only with the key's
rope part shared by every head) against `repro.models.layers`, float64.

As in `tests/test_torch_model.py`, the reference computes RoPE and the
norms in float32 even in a float64 model: the port's float32 islands are
replaced by the reference's functions (`jax_float32_islands`), and the
layer — projections, the paper's normalization, the prefill and decode
kernels' plain versions at Hkv = Hq, D = 24, Dv = 16, the moment state,
the output projection — then agrees to 1e-8. The decode state's dims and
bytes at the full config (Hkv = Hq = 128, D = 192, Dv = 128) equal the
reference's.
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.attention import AttentionSpec as JSpec  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.attention import AttentionSpec  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.param import from_jax_params  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

LOGIT_TOL = 1e-8
F64 = dict(param_dtype="float64", activ_dtype="float64")
B, PLEN, NDEC = 2, 21, 6
ARCH = "deepseek-v2-236b"


def _j(x):
    return jnp.asarray(x.detach().numpy())


def _tt(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def jax_float32_islands(monkeypatch):
    monkeypatch.setattr(TL, "apply_norm", lambda params, x, **kw: _tt(
        JL.apply_norm({k: _j(v) for k, v in params.items()}, _j(x), **kw)))
    monkeypatch.setattr(TL, "rms_norm_headwise", lambda x, eps=1e-6: _tt(
        JL.rms_norm_headwise(_j(x), eps)))
    monkeypatch.setattr(TL, "apply_rope", lambda x, positions, theta: _tt(
        JL.apply_rope(_j(x), _j(positions), theta)))


def _layer(attn, **over):
    jcfg = dataclasses.replace(jsmoke(ARCH), attn=JSpec.parse(attn), **F64,
                               **over)
    tcfg = dataclasses.replace(get_smoke_config(ARCH),
                               attn=AttentionSpec.parse(attn), **F64, **over)
    jparams, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["blocks_0"]["mixer"])
    tp = {k: v[0] for k, v in tparams["blocks_0"]["mixer"].items()}
    return jcfg, tcfg, jp, tp


# (softmax's MLA cache is left to its dims below: the reference's float32
# scores hold its o to ~1e-7, `tests/test_torch_softmax.py`)
@pytest.mark.parametrize("attn,over", [
    ("fastmax2-kernel", {}), ("fastmax2-chunked", {}),
    ("fastmax2-kernel", {"qk_norm": True}), ("fastmax1-kernel", {})],
    ids=["kernel", "chunked", "kernel-qk_norm", "kernel-p1"])
def test_mla_layer_prefill_and_decode_match_jax(attn, over,
                                                jax_float32_islands):
    jcfg, tcfg, jp, tp = _layer(attn, **over)
    assert sorted(jp) == sorted(tp) and "w_dkv" in tp
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, PLEN, jcfg.d_model))
    jst = JL.init_attn_state(jcfg, B, PLEN + NDEC, jnp.float64)
    tst = TL.init_attn_state(tcfg, B, PLEN + NDEC, torch.float64, "cpu")
    jy, jst = JL.attention_prefill(jp, jnp.asarray(x), jst, jcfg)
    ty, tst = TL.attention_prefill(tp, torch.tensor(x), tst, tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for i in range(NDEC):
        xt = rng.normal(size=(B, 1, jcfg.d_model))
        jy, jst = JL.attention_decode(jp, jnp.asarray(xt), jst, jcfg,
                                      position=PLEN + i)
        ty, tst = TL.attention_decode(tp, torch.tensor(xt), tst, tcfg,
                                      position=PLEN + i)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for a, t in zip(jst.moments, tst.moments):
        a = np.asarray(a)
        s = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(t.numpy() / s, a / s, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)


def test_mla_projections_match_jax(jax_float32_islands):
    """q, k, v of the MLA branch at their shapes: k's rope part is the
    same for every head."""
    jcfg, tcfg, jp, tp = _layer("fastmax2-kernel")
    x = np.random.default_rng(4).normal(size=(B, 9, jcfg.d_model))
    pos = np.arange(5, 14)
    jq, jk, jv = JL._project_qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    tq, tk, tv = TL._project_qkv(tp, torch.tensor(x), tcfg,
                                 torch.tensor(pos))
    d = tcfg.qk_nope_dim + tcfg.qk_rope_dim
    assert tuple(tq.shape) == (B, tcfg.n_heads, 9, d) == tuple(tk.shape)
    assert tuple(tv.shape) == (B, tcfg.n_heads, 9, tcfg.head_dim)
    torch.testing.assert_close(tk[:, :1, :, tcfg.qk_nope_dim:].expand(
        -1, tcfg.n_heads, -1, -1), tk[..., tcfg.qk_nope_dim:], rtol=0,
        atol=0)
    for a, t in ((jq, tq), (jk, tk), (jv, tv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("arch,n_layers", [(ARCH, 3), (ARCH, 60),
                                           ("kimi-k2-1t-a32b", 3)])
def test_decode_state_dims_and_bytes_match_jax(arch, n_layers):
    """MLA's state is per query head at D = 192, Dv = 128 (Hkv = Hq); a
    dense first block's state beside the stacked groups; the bytes equal
    the reference's `decode_state_bytes`."""
    from repro.core.decode_state import decode_state_bytes as jbytes
    from repro_torch.core.decode_state import decode_state_bytes as tbytes
    from repro_torch.models import init_decode_state

    jcfg, tcfg = jget(arch, n_layers=n_layers), get_config(arch,
                                                           n_layers=n_layers)
    st = init_decode_state(tcfg, 2, 1024, device="meta")
    assert sorted(st) == ["blocks_0", "dense_0"]
    hkv, dq = TL._kv_dims(tcfg)
    if tcfg.use_mla:
        assert (hkv, dq) == (128, 192)
    m2 = st["blocks_0"].moments.m2
    assert tuple(m2.shape) == (n_layers - 1, 2, hkv, dq, dq, tcfg.head_dim)
    assert tuple(st["dense_0"].moments.m2.shape) == tuple(m2.shape[1:])
    assert tbytes(tcfg, 2, 1024) == jbytes(jcfg, 2, 1024)
    # the softmax KV cache: per query head too, k at D, v at Dv
    jsoft = dataclasses.replace(jcfg, attn=JSpec.parse("softmax"))
    tsoft = dataclasses.replace(tcfg, attn=AttentionSpec.parse("softmax"))
    kv = init_decode_state(tsoft, 2, 1024, device="meta")["dense_0"].kv
    assert tuple(kv.k.shape) == (2, hkv, 1024, dq)
    assert tuple(kv.v.shape) == (2, hkv, 1024, tcfg.head_dim)
    assert tbytes(tsoft, 2, 1024) == jbytes(jsoft, 2, 1024)
