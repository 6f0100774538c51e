"""The port's token data (`repro_torch.data.synthetic`): the reference's
laws, drawn from explicit `torch.Generator`s, on the CPU.

The reference's draws (JAX's threefry streams) cannot be reproduced, so the
laws are tested: tokens stay in the vocabulary; the bigram table's noise is
Gumbel(0, concentration) (a KS test); the chain's first tokens follow
softmax(table[0]) and its transitions softmax(table[previous]) (chi-square
tests at vocab 8, fixed seeds, p > 1e-3); `partition_clients` floors
Dirichlet shares of the pool and raises each to at least 16, as the
reference's.
"""
import jax
import numpy as np
import pytest
import torch
from scipy import stats

from repro.data.synthetic import partition_clients as jpartition_clients
from repro_torch.data.synthetic import make_bigram_table, partition_clients, token_batch, token_stream

torch.set_num_threads(1)
P_MIN = 1e-3


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("vocab", [8, 512])
def test_tokens_stay_in_the_vocabulary(vocab):
    stream = token_stream(_gen(0), vocab, 4, 33)
    for _ in range(3):
        toks = next(stream)
        assert toks.shape == (4, 34) and toks.dtype == torch.int64
        assert int(toks.min()) >= 0 and int(toks.max()) < vocab


def test_bigram_table_is_zipf_plus_gumbel_noise():
    vocab, conc = 256, 0.5
    table = make_bigram_table(_gen(1), vocab, conc)
    assert table.shape == (vocab, vocab) and table.dtype == torch.float32
    noise = table + torch.log(torch.arange(1, vocab + 1, dtype=torch.float32))[None, :]
    assert torch.all(torch.isfinite(noise))
    p = stats.kstest(noise.flatten().numpy(), stats.gumbel_r(loc=0.0, scale=conc).cdf).pvalue
    assert p > P_MIN, p


def test_bigram_chain_follows_softmax_of_the_table():
    vocab = 8
    table = make_bigram_table(_gen(2), vocab)
    probs = torch.softmax(table.double(), dim=-1).numpy()
    toks = token_batch(_gen(3), table, 512, 100).numpy()
    first = np.bincount(toks[:, 0], minlength=vocab)
    assert stats.chisquare(first, probs[0] * first.sum()).pvalue > P_MIN
    prev, nxt = toks[:, :-1].ravel(), toks[:, 1:].ravel()
    chi2, dof = 0.0, 0
    for a in range(vocab):
        counts = np.bincount(nxt[prev == a], minlength=vocab)
        expected = probs[a] * counts.sum()
        chi2 += float(np.sum((counts - expected) ** 2 / expected))
        dof += vocab - 1
    assert stats.chi2.sf(chi2, dof) > P_MIN, chi2


@pytest.mark.parametrize("n_clients,pool,alpha", [(4, 1024, 0.5), (10, 1024, 0.5), (6, 5000, 2.0)])
def test_partition_clients_floors_shares_and_keeps_the_minimum(n_clients, pool, alpha):
    """Each client at least 16; above it, the floored shares sum to the pool
    less under one sample a client, as the reference's do."""
    for seed in range(5):
        for d in (partition_clients(_gen(seed), n_clients, pool, alpha),
                  jpartition_clients(jax.random.PRNGKey(seed), n_clients, pool, alpha)):
            d = np.asarray(d)
            assert d.shape == (n_clients,) and np.all(d >= 16)
            floored = d[d > 16]
            assert floored.sum() <= pool
            assert d.sum() >= pool - n_clients
