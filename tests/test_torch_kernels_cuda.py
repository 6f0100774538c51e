"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips without a card. This file imports neither JAX nor the
reference package, so it runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.fedsem_objective import kernel, ops, ref
from torch_port_util import assert_scores, grid_inputs

XI, ETA, AB = 1e-28, 10, (0.6356, 0.4025)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,N", [(16, 3, 10), (48, 1, 10), (3, 700, 4), (64, 8192, 8)])
@pytest.mark.parametrize("feasible_mask", [True, False], ids=["feas", "raw"])
def test_objective_batch_kernel_matches_plain_version(card, B, G, N, feasible_mask):
    args, mask = grid_inputs(14, B, G, N)
    t = [torch.from_numpy(a).to(card) for a in args]
    kap = [torch.linspace(0.5, 2.0, B, device=card), 1.0, torch.full((B,), 1.3, device=card)]
    kw = dict(xi=XI, eta=ETA, accuracy_ab=AB, dev_mask=torch.from_numpy(mask).to(card),
              check_feasible=feasible_mask)
    before = kernel.launches
    got = ops.objective_grid_batch(*t, *kap, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = ref.objective_grid_batch(*t, *kap, **kw)
    assert_scores(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_objective_grid_kernel_matches_plain_version(card):
    args, _ = grid_inputs(15, 1, 1024, 10)
    t = [torch.from_numpy(a[0]).to(card) for a in args]
    mask = torch.tensor([1.0] * 5 + [0.0] * 5, device=card)
    got = ops.objective_grid(*t, XI, ETA, 0.8, 1.0, 1.2, AB, dev_mask=mask)
    want = ref.objective_grid(*t, XI, ETA, 0.8, 1.0, 1.2, AB, mask)
    assert_scores(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    args, mask = grid_inputs(16, 2, 5, 4)
    t = [torch.from_numpy(a).to(card) for a in args]
    with pytest.raises(ValueError, match="shape"):
        kernel.objective_batch(t[0], t[1][:, :4], *t[2:], None, 1.0, 1.0, 1.0, *AB, xi=XI, eta=ETA)
    with pytest.raises(ValueError, match="is on"):
        kernel.objective_batch(t[0], t[1].cpu(), *t[2:], None, 1.0, 1.0, 1.0, *AB, xi=XI, eta=ETA)
