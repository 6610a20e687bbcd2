"""Card only (``gpu`` marker; skips without a card): the program's
kernel, as the timed path launches it, against the plain reference on the
card at a cell's shapes, bit for bit; and the reference on the card
against itself on the host."""

import numpy as np
import pytest
import torch

from perfbench.frozen.synthetic import mutate, proteins, trajectories
from perfbench.references import erp, levenshtein


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["levenshtein", "erp"])
def test_kernel_equals_reference_on_the_card(card, name):
    from repro_torch.kernels import wavefront as wf
    ref = {"levenshtein": levenshtein, "erp": erp}[name]
    data = (proteins(4096, seed=1) if name == "levenshtein"
            else trajectories(4096, seed=1))
    qs = mutate(data, 4096, seed=2, rate=0.1 if name == "levenshtein"
                else 0.01)
    x, y = torch.as_tensor(qs, device=card), torch.as_tensor(data,
                                                             device=card)
    B, L = x.shape[:2]
    lens = torch.full((B, 2), L, dtype=torch.int32, device=card)
    eps = torch.full((B,), float("inf"), device=card)
    mode = "lev" if name == "levenshtein" else "erp"
    dist, _, _ = wf.wavefront(x.contiguous(), y.contiguous(), lens, eps,
                              mode=mode)
    want = ref.pair_distances(x, y).float()
    assert torch.equal(dist, want)
    host = ref.pair_distances(x.cpu(), y.cpu()).float()
    assert np.array_equal(host.numpy(), want.cpu().numpy())
