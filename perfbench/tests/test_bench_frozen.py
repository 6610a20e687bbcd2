"""The frozen copies against the program's originals, seed for seed."""

import numpy as np
import pytest
import torch

from perfbench.frozen import costs, synthetic


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_generators_equal_the_programs(seed):
    import chip_smoke
    from repro_torch.data import synthetic as port
    assert np.array_equal(synthetic.proteins(300, seed=seed),
                          port.proteins(300, seed=seed))
    assert np.array_equal(synthetic.trajectories(300, seed=seed),
                          port.trajectories(300, seed=seed))
    for data in (port.proteins(300, seed=1), port.trajectories(300, seed=1)):
        for rate in (0.1, 0.01):
            assert np.array_equal(
                synthetic.mutate(data, 40, seed, rate=rate),
                chip_smoke.mutate(data, 40, seed, rate=rate))


def test_costs_equal_the_programs():
    from repro_torch.roofline import costs as port
    for k in ("PEAK_F32_FLOPS", "PEAK_F32_OPS", "PEAK_TF32_FLOPS",
              "PEAK_BF16_FLOPS", "PEAK_BYTES"):
        assert getattr(costs, k) == getattr(port, k)
    rng = np.random.default_rng(0)
    for mode, shape in (("lev", (64, 20)), ("erp", (64, 20, 2)),
                        ("erp", (8, 24, 8))):
        xs = torch.zeros(shape)
        lx = rng.integers(1, shape[1] + 1, shape[0])
        ly = rng.integers(1, shape[1] + 1, shape[0])
        eps = np.where(rng.random(shape[0]) < 0.5, 2.0, np.inf)
        assert costs.wavefront_cost(mode, xs, xs, lx, ly, eps) == \
            port.wavefront_cost(mode, xs, xs, lx, ly, eps)


def test_stream_seeds():
    from perfbench import traffic
    assert traffic.stream_seed(2**31 + 5, "data") == \
        traffic.stream_seed(2**31 + 5, "data")
    assert traffic.stream_seed(-3, "data") != traffic.stream_seed(3, "data")
