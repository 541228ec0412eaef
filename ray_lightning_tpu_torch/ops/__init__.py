"""Attention ops and the hand-written CUDA kernels behind them:
``flash_attention`` (prefill, ``csrc/flash_fwd.cu``) and
``flash_decode`` (decode, ``csrc/flash_decode.cu``), each beside its
plain PyTorch version; ``_kernels`` builds and binds them."""
