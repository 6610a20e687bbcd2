"""`repro_torch` — the PyTorch/CUDA port of the subsequence-retrieval
framework.

A package beside the JAX reference ``repro``: same module layout, torch
tensors with an explicit ``device`` (the card by default), and the
wavefront alignment DP as a hand-written CUDA kernel
(``kernels/csrc/wavefront.cu``).  The entry point is
``repro_torch.retrieval``: ``Retriever.build(RetrievalConfig(...), data)``.
"""
