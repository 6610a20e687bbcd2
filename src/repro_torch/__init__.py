"""`repro_torch` — the PyTorch/CUDA port of the subsequence-retrieval
framework.

A package beside the JAX reference ``repro``: same module layout, torch
tensors with an explicit ``device`` (the card by default), and the
reference's TPU kernels as hand-written CUDA kernels: the wavefront
alignment DP (``kernels/csrc/wavefront.cu``) and the pairwise Euclidean
matrix (``kernels/csrc/pairwise_l2.cu``).  The entry point is
``repro_torch.retrieval``: ``Retriever.build(RetrievalConfig(...), data)``
(``execution="fleet"`` shards it over an elastic fleet, ``serve()`` puts
the continuous-batching serve engine on top; ``launch/serve.py`` is its
CLI); ``models`` and ``core/embedding_retrieval.py`` turn a dense transformer's
hidden states into vectors for its ``embedding`` index kind.
"""
