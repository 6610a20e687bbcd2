"""Database generators, one module per dataset name that a configuration's
file gives; each exposes ``generate(n_windows, l, seed, **args)``."""
