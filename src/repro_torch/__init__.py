"""repro_torch — the PyTorch/CUDA port of `repro` (FAST / Fastmax attention).

Sub-packages mirror the JAX package (`core`, `kernels`, `attention`,
`models`, `configs`, `launch`, `serve`, `ft`) so every module has a
counterpart of the same path. The port imports `torch` and `numpy` only. Entry points run on
`cuda` unless the caller passes `device="cpu"`; asking for `cuda` on a
machine without a card raises (`repro_torch.device.resolve_device`).
"""
