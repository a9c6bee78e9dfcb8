"""Core fastmax math and the softmax baseline (port of `repro.core`)."""
from repro_torch.core.decode_state import (  # noqa: F401
    decode_state_bytes,
    fastmax_decode_step,
    fastmax_prefill,
    init_fastmax_state,
)
from repro_torch.core.fastmax import (  # noqa: F401
    Moments,
    combine_with_queries,
    compute_moments,
)
from repro_torch.core.ref import (  # noqa: F401
    fastmax_attention_ref,
    normalize_qk,
    poly_kernel,
    softmax_attention_ref,
)
from repro_torch.core.softmax import softmax_attention  # noqa: F401
