"""Shims over the scenario registry (`repro_torch.scenarios`).

Counterpart of `repro.core.channel`: `sample_params` and
`sample_params_batch` draw from the ``iid_rayleigh`` family (the paper's
Section-V law), with an int seed or a `torch.Generator` where the reference
takes a JAX key. New code resolves a family by name instead:

    from repro_torch.scenarios import get_family
    params = get_family("iid_rayleigh").sample(0, N=10, K=50)

`sample_request_stream` is the serving slice's and raises until then. The
imports of `repro_torch.scenarios` sit in the function bodies because that
package imports `repro_torch.core.types`.
"""
from __future__ import annotations

from .types import SystemParams


def sample_params(seed, **kwargs) -> SystemParams:
    """One ``iid_rayleigh`` scenario (``get_family("iid_rayleigh").sample``)."""
    from repro_torch.scenarios import get_family

    return get_family("iid_rayleigh").sample(seed, **kwargs)


def sample_params_batch(seed, batch: int, **kwargs) -> SystemParams:
    """A stacked batch of ``iid_rayleigh`` scenarios
    (``get_family("iid_rayleigh").sample_batch``)."""
    from repro_torch.scenarios import get_family

    return get_family("iid_rayleigh").sample_batch(seed, batch, **kwargs)


def sample_request_stream(seed, n_requests: int, **kwargs) -> list:
    """The serving request stream (``get_family("iid_rayleigh").stream``):
    not ported yet, ROADMAP.md §1, item 8."""
    from repro_torch.scenarios import get_family

    return get_family("iid_rayleigh").stream(seed, n_requests, **kwargs)
