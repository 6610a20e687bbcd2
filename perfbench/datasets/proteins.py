"""The paper's PROTEINS, synthetic: alphabet-20 windows drawn from planted
motifs with point mutations (the frozen copy of the port's generator)."""

from perfbench.frozen.synthetic import proteins


def generate(n_windows: int, l: int, seed: int, **args):
    return proteins(n_windows, l=l, seed=seed, **args)
