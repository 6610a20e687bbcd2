"""The model half of the port: parameter trees, dense transformer layers
and the architecture registry (``registry.get``)."""
