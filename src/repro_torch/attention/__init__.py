"""Attention-operator API of the port (softmax, fastmax and hybrid
families): spec,
registry, the full-sequence `attention()` dispatcher and the decode-state
protocol."""
from repro_torch.attention.api import attention  # noqa: F401
from repro_torch.attention.registry import (  # noqa: F401
    Backend,
    Capabilities,
    get_backend,
    list_backends,
    register,
    resolve,
)
from repro_torch.attention.spec import AttentionSpec  # noqa: F401
from repro_torch.attention.state import (  # noqa: F401
    AttnState,
    KVCache,
    init_state,
    prefill,
    step,
)
