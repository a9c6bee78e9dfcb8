"""Kernel entry points — port of `repro/kernels/ops.py` (fastmax, hybrid).

Dispatch is by the tensors' device, with no fallback:
  * CUDA tensors launch the hand-written kernels (`csrc/*.cu`), or raise;
  * CPU tensors take the kernels' plain versions — the tests' route;
  * `meta` tensors take the meta route (`kernels.meta`): meta outputs of
    the CUDA route's shapes and dtypes, with the CUDA call's workspace
    allocated on meta for as long as it would hold it. It launches
    nothing, runs no plain version and yields no value: it is how the dry
    run (`launch/dryrun.py`) counts a step without a card.
Inside the dry run's counting context (`launch/op_analysis.py`, which sets
`_RECORD`) the CUDA and meta routes record each launch they make or would
make — the kernel, the plan it runs under (`under_plan`, set by
`kernels.sharded`), its shapes and its work (`kernels.work`) — and every
route, the plain versions' included, notes its routing line. Outside that
context nothing is recorded and every path is as before.
The trainable causal `fastmax()` pairs the forward kernel, which emits its
final moment carry, with the §2.5 backward kernel; the carry is the only
residual beyond (q, k, v). The noncausal one pairs the two-launch noncausal
kernel with autograd of the plain `core.fastmax.fastmax_noncausal`, as the
reference does (it has no noncausal backward kernel). The trainable
`hybrid()` pairs the hybrid kernel, which also emits its final moment
carry, with the plain band-extended §2.5 reverse scan
(`core.hybrid.hybrid_bwd_scan`) seeded by that carry, as the reference
does (it has no hybrid backward kernel). `hybrid_prefill_kernel` is the
hybrid kernel's serving route: the prompt's o and final moments.

Every kernel launch consults the schedule autotuner once
(`kernels.autotune.lookup_schedule`, as the reference's ops do): with
REPRO_TORCH_AUTOTUNE off it returns None and the wrappers launch with their
own constants. A `schedule=` forces one `autotune.Schedule` on the call's
forward launches (tests); one the kernel does not take at the launch's
shape raises ValueError. The backward kernel has no knob, so it makes no
lookup and takes no schedule. CPU tensors take the plain versions: the
schedule is chosen but has no effect.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core import hybrid as _hy
from repro_torch.core.fastmax import Moments
from repro_torch.kernels import autotune as _at
from repro_torch.kernels import fastmax_causal as _fc
from repro_torch.kernels import fastmax_causal_bwd as _fb
from repro_torch.kernels import fastmax_decode as _fd
from repro_torch.kernels import fastmax_noncausal as _fn
from repro_torch.kernels import hybrid_causal as _hc
from repro_torch.kernels import meta as _meta
from repro_torch.kernels import work as _w
from repro_torch.kernels.ref import fastmax_decode_ref

__all__ = ["fastmax", "fastmax_bwd", "fastmax_prefill_kernel",
           "fastmax_decode", "hybrid", "hybrid_prefill_kernel",
           "launch_counts", "reset_launch_counts", "under_plan",
           "note_route"]

# the counting context's record (`launch/op_analysis.py` sets it to a dict
# with "launches", a list, and "routes", a set), else None
_RECORD = None
# descriptions of the kernel plans the calls inside run under
_PLANS: list = []


def _route(x: torch.Tensor) -> str:
    if x.device.type == "cuda":
        return "cuda"
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "meta":
        return "meta"
    raise ValueError(f"no fastmax kernel for device {x.device}")


@contextlib.contextmanager
def under_plan(desc):
    """The kernel calls inside run on a plan's shards (`desc`,
    `ShardPlan.describe()`; None: on one device)."""
    _PLANS.append(desc)
    try:
        yield
    finally:
        _PLANS.pop()


def _plan():
    return _PLANS[-1] if _PLANS else None


def note_route(line: str) -> None:
    """Record a routing line (inside the counting context only)."""
    if _RECORD is not None:
        _RECORD["routes"].add(line)


def _note(route: str, kernel: str, work, dtype, **shape) -> None:
    """Record a launch of `kernel` made (cuda) or standing in (meta), or
    the plain version taken (cpu), inside the counting context."""
    if _RECORD is None:
        return
    if route == "plain":
        note_route(f"plain {kernel} (the kernel's plain version)")
        return
    plan = _plan()
    if plan is None:
        from repro_torch.sharding.rules import active_mesh, mesh_axes

        mesh = active_mesh()
        where = ("on one device" if mesh is None or all(
            n == 1 for n in mesh_axes(mesh).values())
            else "on the whole heads: no plan divides the mesh")
    note_route(f"kernel {kernel} " + (plan or where))
    ops_n, nbytes = work
    _RECORD["launches"].append({
        "kernel": kernel, "route": route, "plan": plan,
        "dtype": str(dtype).replace("torch.", ""), "shape": shape,
        "ops": int(ops_n), "bytes": int(nbytes)})


def _dims(q, k, v) -> dict:
    b, hq, n, d = q.shape
    return dict(b=b, hq=hq, hkv=k.shape[1], n=n, d=d, dv=v.shape[-1])


def _segments(s: dict, p: int) -> int:
    return _meta.segments(s["b"] * s["hkv"], s["n"], s["d"], s["dv"], p)


def _note_prefill(route, kernel, q, k, v, p, w_eff=0):
    s = _dims(q, k, v)
    size = q.element_size()
    if w_eff:
        work = _w.hybrid_work(**s, w_eff=w_eff, itemsize=size, p=p)
        _note(route, kernel, work, q.dtype, **s, p=p, w_eff=w_eff,
              segments=_segments(s, p))
    else:
        work = _w.prefill_work(**s, itemsize=size, p=p)
        _note(route, kernel, work, q.dtype, **s, p=p,
              segments=_segments(s, p))


def _lookup(kernel: str, q, k, v, p: int, schedule):
    """The launch's schedule: the forced one (checked against the kernel
    and shape), else the autotuner's (None when it is off: the wrapper's
    constants)."""
    shape = dict(n=q.shape[2], d=q.shape[3], dv=v.shape[-1],
                 g=q.shape[1] // k.shape[1], bh=q.shape[0] * k.shape[1], p=p,
                 dtype=q.dtype, device=q.device)
    if schedule is not None:
        return _at.check_schedule(kernel, schedule, **shape)
    return _at.lookup_schedule(kernel, **shape)


class _FastmaxCausal(torch.autograd.Function):
    """Causal fastmax on pre-normalized q̂/k̂: the forward kernel (which
    emits its final carry) paired with the §2.5 backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, p, chunk_size, denom_eps, schedule):
        o, state = fastmax_prefill_kernel(q, k, v, p=p, chunk_size=chunk_size,
                                          denom_eps=denom_eps,
                                          schedule=schedule)
        if p < 2:
            # don't hold the [B,Hkv,D,D,Dv] zeros placeholder as a residual
            state = state[:2] + (None,) + state[3:5] + (None,)
        ctx.save_for_backward(q, k, v, *(t for t in state if t is not None))
        ctx.cfg = (p, chunk_size, denom_eps)
        ctx.plan = _plan()
        return o

    @staticmethod
    def backward(ctx, do):
        p, chunk_size, denom_eps = ctx.cfg
        q, k, v, *st = ctx.saved_tensors
        if p < 2:
            st = st[:2] + [None] + st[2:] + [None]
        with under_plan(ctx.plan):
            dq, dk, dv = fastmax_bwd(q, k, v, tuple(st), do, p=p,
                                     chunk_size=chunk_size,
                                     denom_eps=denom_eps)
        return dq, dk, dv, None, None, None, None


class _FastmaxNoncausal(torch.autograd.Function):
    """Noncausal fastmax on pre-normalized q̂/k̂ (k, v may hold M != N
    keys): the moment + combine kernel forward; the backward is autograd
    of the plain moment path (one global moment sum, so no O(N M) scores),
    as the reference's `_fnc_bwd` is."""

    @staticmethod
    def forward(ctx, q, k, v, p, chunk_size, denom_eps, schedule):
        schedule = _lookup("noncausal", q, k, v, p, schedule)
        route = _route(q)
        if route == "cuda":
            o = _fn.fastmax_noncausal_cuda(q.contiguous(), k.contiguous(),
                                           v.contiguous(), p=p,
                                           denom_eps=denom_eps,
                                           schedule=schedule)
        elif route == "meta":
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
            o = _meta.noncausal_combine(
                qc, _meta.noncausal_moments(kc, vc, p=p), p=p,
                schedule=schedule)
            del qc, kc, vc
        else:
            o = _fn.fastmax_noncausal_ref(q, k, v, p=p,
                                          chunk_size=chunk_size,
                                          denom_eps=denom_eps)
        b, hq, n, d = q.shape
        hkv, m, dv = k.shape[1], k.shape[2], v.shape[-1]
        _note(route, "fastmax_noncausal_moments",
              _w.noncausal_moments_work(b, hkv, m, d, dv, q.element_size(),
                                        p), q.dtype, b=b, hkv=hkv, m=m, d=d,
              dv=dv, p=p)
        _note(route, "fastmax_noncausal_combine",
              _w.noncausal_combine_work(b, hq, hkv, n, d, dv,
                                        q.element_size(), p), q.dtype, b=b,
              hq=hq, hkv=hkv, n=n, d=d, dv=dv, p=p)
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (p, chunk_size, denom_eps)
        return o

    @staticmethod
    def backward(ctx, do):
        p, chunk_size, denom_eps = ctx.cfg
        note_route("backward fastmax_noncausal: autograd of the moment path "
                   "(no backward kernel, as in the reference)")
        prim = [x.detach().requires_grad_(True) for x in ctx.saved_tensors]
        with torch.enable_grad():
            o = _fn.fastmax_noncausal_ref(*prim, p=p,
                                          chunk_size=max(chunk_size, 512),
                                          denom_eps=denom_eps)
            dq, dk, dv = torch.autograd.grad(o, prim, do)
        return dq, dk, dv, None, None, None, None


def fastmax(q, k, v, *, p: int = 2, causal: bool = True,
            chunk_size: int = 128, denom_eps: float = 1e-6, schedule=None):
    """Trainable kernel-backed fastmax on pre-normalized q̂/k̂ (GQA-aware),
    o in q's dtype. Noncausal k, v may hold M != N keys (cross-attention).
    `chunk_size` is the plain versions' chunk; the kernels pick their
    own. `schedule` forces one schedule on the forward's launches (the
    backward kernel has none)."""
    if not causal:
        return _FastmaxNoncausal.apply(q, k, v, p, chunk_size, denom_eps,
                                       schedule)
    return _FastmaxCausal.apply(q, k, v, p, chunk_size, denom_eps, schedule)


class _HybridCausal(torch.autograd.Function):
    """Hybrid attention on pre-normalized q̂/k̂: the hybrid kernel (which
    emits its final moment carry) paired with the plain band-extended §2.5
    reverse scan, seeded by that carry and re-chunked at the model's
    `chunk_size` (the band w_eff depends on it)."""

    @staticmethod
    def forward(ctx, q, k, v, p, window, chunk_size, denom_eps, schedule):
        o, state = hybrid_prefill_kernel(q, k, v, p=p, window=window,
                                         chunk_size=chunk_size,
                                         denom_eps=denom_eps,
                                         schedule=schedule)
        if p < 2:
            # don't hold the [B,Hkv,D,D,Dv] zeros placeholder as a residual
            state = state[:2] + state[3:5]
        ctx.save_for_backward(q, k, v, *state)
        ctx.cfg = dict(p=p, window=window, chunk_size=chunk_size,
                       denom_eps=denom_eps)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, *st = ctx.saved_tensors
        if ctx.cfg["p"] < 2:
            m0, m1, g0, g1 = st
            d, dv = q.shape[-1], v.shape[-1]
            st = [m0, m1, m1.new_zeros(m1.shape[:2] + (d, d, dv)), g0, g1,
                  g1.new_zeros(g1.shape[:2] + (d, d))]
        note_route("backward hybrid_causal: the band-extended §2.5 scan (no "
                   "backward kernel, as in the reference)")
        dq, dk, dv = _hy.hybrid_bwd_scan(q, k, v, Moments(*st), do,
                                         **ctx.cfg)
        return dq, dk, dv, None, None, None, None, None


def hybrid(q, k, v, *, p: int = 2, window: int = 64, causal: bool = True,
           chunk_size: int = 128, denom_eps: float = 1e-6, schedule=None):
    """Trainable kernel-backed hybrid attention on pre-normalized q̂/k̂
    (causal only), o in q's dtype. The band is w_eff = min(window,
    chunk_size); at w_eff = 0 this is `fastmax()`. `schedule` forces one
    schedule on the hybrid kernel's launch."""
    if not causal:
        raise ValueError("hybrid kernels are causal-only")
    if _hy.effective_window(window, chunk_size) == 0:
        return fastmax(q, k, v, p=p, causal=True, chunk_size=chunk_size,
                       denom_eps=denom_eps, schedule=schedule)
    return _HybridCausal.apply(q, k, v, p, window, chunk_size, denom_eps,
                               schedule)


def fastmax_bwd(q, k, v, state, do, *, p: int = 2, chunk_size: int = 128,
                denom_eps: float = 1e-6, return_dstate: bool = False):
    """Causal fastmax backward on the forward's final carry: (dq, dk, dv),
    plus the initial carry's cotangent with `return_dstate`. CUDA tensors
    launch the §2.5 backward kernel, CPU tensors take its plain version.
    `state` may carry None for m2/g2 at p < 2. Meta tensors take the meta
    route."""
    route = _route(q)
    s = _dims(q, k, v)
    _note(route, "fastmax_causal_bwd",
          _w.bwd_work(**s, itemsize=q.element_size(), p=p), q.dtype, **s,
          p=p, segments=_segments(s, p))
    if route == "plain":
        return _fb.fastmax_causal_bwd_ref(q, k, v, state, do, p=p,
                                          chunk_size=chunk_size,
                                          denom_eps=denom_eps,
                                          return_dstate=return_dstate)
    args = (q.contiguous(), k.contiguous(), v.contiguous(), state,
            do.to(q.dtype).contiguous())
    if route == "meta":
        return _meta.bwd(*args, p=p, return_dstate=return_dstate)
    return _fb.fastmax_causal_bwd_cuda(*args, p=p, denom_eps=denom_eps,
                                       return_dstate=return_dstate)


def fastmax_prefill_kernel(q, k, v, *, p: int = 2, chunk_size: int = 128,
                           denom_eps: float = 1e-6, kv_mask=None,
                           init_state=None, schedule=None):
    """Causal prefill on pre-normalized q̂/k̂. Returns (o, state): o in q's
    dtype and the final moment carry (m0, m1, m2, g0, g1, g2), m2 m-major
    [B,Hkv,D,D,Dv] — the layout `fastmax_decode` reads. `init_state`
    seeds the carry (resumable prefill); `kv_mask` [B, Hkv|1, N] weights
    the keys. `chunk_size` is the plain version's chunk; the kernel picks
    its own (the fold is associative: only rounding differs). Meta
    tensors take the meta route."""
    schedule = _lookup("causal_fwd", q, k, v, p, schedule)
    route = _route(q)
    _note_prefill(route, "fastmax_causal", q, k, v, p)
    if route == "plain":
        return _fc.fastmax_causal_ref(q, k, v, kv_mask, p=p,
                                      chunk_size=chunk_size,
                                      denom_eps=denom_eps,
                                      init_state=init_state)
    args = (q.contiguous(), k.contiguous(), v.contiguous(), kv_mask)
    if route == "meta":
        return _meta.prefill(*args, p=p, init_state=init_state)
    return _fc.fastmax_causal_cuda(*args, p=p, denom_eps=denom_eps,
                                   init_state=init_state, schedule=schedule)


def hybrid_prefill_kernel(q, k, v, *, p: int = 2, window: int = 64,
                          chunk_size: int = 128, denom_eps: float = 1e-6,
                          kv_mask=None, schedule=None):
    """Hybrid causal prefill on pre-normalized q̂/k̂ (no carried state).
    Returns (o, state): o in q's dtype and the final moment carry in the
    layout of `fastmax_prefill_kernel`. `kv_mask` [B, Hkv|1, N] removes
    keys from both legs. CUDA tensors launch the hybrid kernel, CPU
    tensors take its plain version (the chunked hybrid scan at
    `chunk_size`), meta tensors the meta route."""
    kw = dict(p=p, window=window, chunk_size=chunk_size,
              denom_eps=denom_eps, return_state=True)
    schedule = _lookup("hybrid_fwd", q, k, v, p, schedule)
    route = _route(q)
    w_eff = _hc.band_width(window, chunk_size, q.shape[2])
    _note_prefill(route, "hybrid_causal" if w_eff else "fastmax_causal",
                  q, k, v, p, w_eff)
    if route == "plain":
        return _hc.hybrid_causal_ref(q, k, v, kv_mask, **kw)
    args = (q.contiguous(), k.contiguous(), v.contiguous(), kv_mask)
    if route == "meta":
        return _meta.prefill(*args, p=p)
    return _hc.hybrid_causal_cuda(*args, **kw, schedule=schedule)


def fastmax_decode(q, k, v, state, *, p: int = 2, denom_eps: float = 1e-6,
                   schedule=None):
    """One decode step on pre-normalized q̂/k̂: folds (k̂, v) into `state`
    IN PLACE (the tensors of the moment tuple are mutated) and returns
    o [B,Hq,1,Dv] in q's dtype, computed against the updated moments.
    Meta tensors take the meta route (no value, so nothing to update)."""
    schedule = _lookup("decode", q, k, v, p, schedule)
    route = _route(q)
    b, hq, _, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    _note(route, "fastmax_decode",
          _w.decode_work(b, hq, hkv, d, dv, q.element_size(), p), q.dtype,
          b=b, hq=hq, hkv=hkv, d=d, dv=dv, p=p)
    if route != "plain":
        args = (q.contiguous(), k.contiguous(), v.contiguous(), tuple(state))
        if route == "meta":
            return _meta.decode(*args, p=p, schedule=schedule)
        return _fd.fastmax_decode_cuda(*args, p=p, denom_eps=denom_eps,
                                       schedule=schedule)
    o, new = fastmax_decode_ref(q, k, v, tuple(state), p=p,
                                denom_eps=denom_eps)
    for dst, src in zip(state, new):
        dst.copy_(src)
    return o


def launch_counts() -> dict:
    """Kernel launches so far, per kernel (CPU calls launch nothing)."""
    return {"fastmax_causal": _fc.launches,
            "fastmax_causal_bwd": _fb.launches,
            "fastmax_decode": _fd.launches,
            "fastmax_noncausal_moments": _fn.moment_launches,
            "fastmax_noncausal_combine": _fn.combine_launches,
            "hybrid_causal": _hc.launches}


def reset_launch_counts() -> None:
    _fc.launches = 0
    _fb.launches = 0
    _fd.launches = 0
    _fn.moment_launches = 0
    _fn.combine_launches = 0
    _hc.launches = 0
