"""Core fastmax math (port of `repro.core`)."""
from repro_torch.core.decode_state import init_fastmax_state  # noqa: F401
from repro_torch.core.fastmax import (  # noqa: F401
    Moments,
    combine_with_queries,
    compute_moments,
)
from repro_torch.core.ref import (  # noqa: F401
    fastmax_attention_ref,
    normalize_qk,
    poly_kernel,
)
