"""The discrete Fréchet reference (``references/frechet.py``) against
hand-worked distances, against the program's own numpy-order distance
(bit for bit) at the ``traj-dfd-l64`` cell's 64 x 64 x 2, and its
bfloat16 control against it."""

import numpy as np
import pytest
import torch

from perfbench.references import frechet


def _dfd(x, y, dtype=frechet.DTYPE):
    return float(frechet.pair_distances(torch.tensor([x]), torch.tensor([y]),
                                        dtype)[0])


@pytest.mark.parametrize("x, y, d", [
    ([[0.0, 0.0]], [[3.0, 4.0]], 5.0),                  # one pair
    ([[0.0, 0.0], [1.0, 0.0]], [[0.0, 0.0], [1.0, 0.0]], 0.0),
    # y waits at its first point while x moves: the couplings' max
    ([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]], [[0.0, 1.0], [2.0, 1.0]],
     2.0 ** 0.5),
    # the end points are always paired: (0, 0)-(0, 0) and (4, 0)-(0, 3)
    ([[0.0, 0.0], [4.0, 0.0]], [[0.0, 0.0], [0.0, 3.0]], 5.0),
    # a detour of y costs its distance from x's nearest point, not a sum
    ([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]],
     [[0.0, 0.0], [1.0, 2.0], [2.0, 0.0]], 2.0),
])
def test_hand_worked(x, y, d):
    assert _dfd(x, y) == pytest.approx(d, rel=1e-7)
    assert _dfd(y, x) == pytest.approx(d, rel=1e-7)


def _pairs():
    from perfbench.frozen.synthetic import mutate, trajectories
    tr = trajectories(300, l=64, seed=3)
    return mutate(tr, 300, seed=4, rate=0.1), tr


def test_equals_the_programs_numpy_order_bit_for_bit():
    """The program holds every float distance to numpy's order (its
    ``np_backend``); the reference, written apart, agrees bit for bit, so
    a window at exactly ``eps`` is judged alike."""
    from repro_torch.distances import np_backend
    q, tr = _pairs()
    want = np_backend.batch_for("frechet")(q, tr)
    got = frechet.pair_distances(torch.as_tensor(q), torch.as_tensor(tr))
    assert np.array_equal(got.numpy(), np.asarray(want, np.float32))


def test_control_differs():
    """bfloat16 rounds the coordinates and the costs; max and min round
    nothing, so the costs alone move the distances."""
    q, tr = _pairs()
    x, y = torch.as_tensor(q), torch.as_tensor(tr)
    exact = frechet.pair_distances(x, y)
    ctl = frechet.pair_distances(x, y, frechet.CONTROL["dtype"]).float()
    assert frechet.CONTROL["strict"] is False
    assert (ctl != exact).float().mean() > 0.5
    assert float((ctl - exact).abs().max()) < 1.0


@pytest.mark.gpu
def test_kernel_block_schedule_equals_reference_on_the_card():
    """Card only: the wavefront kernel in ``dfd`` mode on its block
    schedule, at the cell's 64 x 64 x 2, against the reference on the card
    and on the host, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench.frozen.synthetic import mutate, trajectories
    from repro_torch.kernels import wavefront as wf
    card = torch.device("cuda", 0)
    data = trajectories(4096, l=64, seed=1)
    qs = mutate(data, 4096, seed=2, rate=0.1)
    x, y = torch.as_tensor(qs, device=card), torch.as_tensor(data,
                                                             device=card)
    B, L = x.shape[:2]
    assert wf.schedule("dfd", L, L, 2) == "block"
    lens = torch.full((B, 2), L, dtype=torch.int32, device=card)
    eps = torch.full((B,), float("inf"), device=card)
    dist, _, _ = wf.wavefront(x.contiguous(), y.contiguous(), lens, eps,
                              mode="dfd")
    want = frechet.pair_distances(x, y)
    assert torch.equal(dist, want)
    host = frechet.pair_distances(x.cpu(), y.cpu())
    assert np.array_equal(host.numpy(), want.cpu().numpy())
