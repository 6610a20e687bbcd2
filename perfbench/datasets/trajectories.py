"""The paper's TRAJ, synthetic: 2-D smooth-heading random walks (the frozen
copy of the port's generator)."""

from perfbench.frozen.synthetic import trajectories


def generate(n_windows: int, l: int, seed: int, **args):
    return trajectories(n_windows, l=l, seed=seed, **args)
