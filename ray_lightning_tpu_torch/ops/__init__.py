"""Attention ops and the hand-written CUDA kernels behind them:
``flash_attention`` (forward ``csrc/flash_fwd.cu``, backward
``csrc/flash_bwd.cu``) and ``flash_decode`` (decode,
``csrc/flash_decode.cu``), each beside its plain PyTorch version;
``_kernels`` builds and binds them.  ``losses`` and ``optim`` are the
training path's plain PyTorch loss and AdamW."""
