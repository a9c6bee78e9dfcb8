"""Data pipeline: synthetic + memmap-backed token streams, host-sharded."""
from repro_torch.data.pipeline import (  # noqa: F401
    MemmapDataset,
    SyntheticLM,
    make_batch_iterator,
    write_token_file,
)
