"""Model configurations the port runs (``base.ModelConfig`` plus one
module per architecture, each with ``CONFIG`` and ``reduced()``)."""
