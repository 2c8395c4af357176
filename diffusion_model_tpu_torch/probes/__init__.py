"""The TPU package's hardware probes (``benchmarks/probe_*.py``), ported as
hand-written CUDA kernels for Hopper: ``matmul_rate`` (P2), ``overlap``
(P4), ``pipeline`` (P3) and ``kernel_stages`` (P1). Each module holds its
kernel's wrapper, the plain PyTorch version beside it and a ``main()``
(``python -m diffusion_model_tpu_torch.probes.<name>``) that needs a card.
"""
