"""The closed FedSem loop: FL-train the paper's SemCom autoencoder with the
allocator's per-round rho reconfiguring the codec, and feed the measured
accuracy back into the allocator's A(rho) model.

Counterpart of `repro.fl.semcom_job`. A `SemComJob`:

  * runs the round's solved rho into the codec as a run-time bottleneck
    (`semcom.latent_mask` keeps ceil(rho * base_latent) latent channels; the
    paper's extra pooling stage for rho <= 0.5 is a python branch on the
    round's rho, where the reference has a `lax.cond`). Parameters stay at
    the rho = 1 shape, so FedAvg aggregates across rounds of different rho,
    and `run_fl`'s top-|rho| sparsification compresses the uploads with the
    same rho;
  * after each round measures the proxy accuracy through the codec at the
    round's rho and at fixed probe rhos, and once enough measurements are in
    re-fits ``A(rho) = a rho^b`` (`core.fit_power_law`, clipped to
    Assumption 1) and pushes the fit into a live backend
    (`AllocationBackend.set_accuracy`): later rounds are allocated against
    the job's own accuracy curve. `PlannedBackend` declines (it solved every
    round up front); the refusal is recorded, not an error.

Randomness comes from generators derived from the job's seed (`fold_seed`);
the job touches no global RNG, so jobs in threads stay independent. On the
card a job asks cuDNN for deterministic convolution algorithms (see `run`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import AccuracyFn, fit_power_law
from ..data.synthetic import image_batch
from ..device import resolve_device
from ..scenarios import generator
from ..semcom.autoencoder import AEConfig, init_params, mse_loss_rho, proxy_accuracy_rho
from .alloc_backend import AllocationBackend
from .federated import FLConfig, RoundStats, fold_seed, run_fl


class SemComJobConfig(NamedTuple):
    fl: FLConfig = FLConfig(n_clients=4, n_subcarriers=12, rounds=6, local_steps=2)
    ae: AEConfig = AEConfig(hidden=8)
    batch_size: int = 8
    eval_batch: int = 16
    #: measure accuracy at these rhos every round besides the solved one, so
    #: the refit always sees rho diversity (solved rhos can cluster tightly)
    probe_rhos: tuple = (0.25, 0.75)
    #: rounds of measurements to accumulate before the first refit
    refit_after: int = 2
    #: push refits into the backend (`set_accuracy`); False keeps measuring
    #: but never changes the allocator's curve (the equivalence-gate mode)
    feedback: bool = True
    name: str = "semcom"


class SemComJobResult(NamedTuple):
    name: str
    params: dict
    history: list[RoundStats]
    #: every (rho, proxy_accuracy) measurement, solved and probe rhos alike
    measurements: list[tuple[float, float]]
    #: the last A(rho) re-fit (None when too few rounds ran to fit)
    accuracy_fit: AccuracyFn | None
    #: True iff a fit was pushed into the backend and the backend took it
    refit_applied: bool
    #: round index of the first applied refit (None if never applied)
    refit_round: int | None


class SemComJob:
    """One FL job training the SemCom autoencoder (see module docstring) on
    ``device`` (the card unless the caller asks for the CPU).

    ``run(seed, backend=None)`` drives `run_fl` with the codec's rho-aware
    loss; the default backend is the offline planner, a `ServiceBackend`
    closes the loop through the live serving stack.
    """

    def __init__(self, cfg: SemComJobConfig = SemComJobConfig(), device="cuda"):
        # params live at the rho = 1 shape; rho is applied at run time
        self.ae = cfg.ae._replace(rho=1.0)
        self.cfg = cfg._replace(fl=cfg.fl._replace(rho_in_loss=True))
        self.device = resolve_device(device)

    def _loss_fn(self, p, batch, gen, rho):
        # the extra pooling stage (rho <= 0.5, rho in float32 as the
        # reference's traced rho) changes shapes, so it is a branch
        return mse_loss_rho(p, self.ae, batch, rho, gen, extra_pool=bool(rho <= 0.5))

    def _batch_fn(self, gen, client_idx):
        del client_idx  # synthetic shards differ through the generator only
        return image_batch(gen, self.cfg.batch_size, size=self.ae.image_size,
                           channels=self.ae.channels)

    def _measure(self, params, x_eval, noise_seed: int, rho: float) -> float:
        """The proxy accuracy at ``rho``, with the channel noise of
        ``noise_seed`` (every rho of a round sees the same draw)."""
        with torch.no_grad():
            return float(proxy_accuracy_rho(
                params, self.ae, x_eval, torch.tensor(rho, dtype=torch.float32),
                generator(noise_seed, self.device), extra_pool=rho <= 0.5,
            ))

    def run(self, seed: int, backend: AllocationBackend | None = None) -> SemComJobResult:
        cfg = self.cfg
        if self.device.type == "cuda":
            # cuDNN's autotuned and nondeterministic convolution algorithms
            # would make a co-tenanted run and its solo re-run differ
            # (`fedsem_e2e`'s exact non-interference gate). Process-wide and
            # left set: jobs train in threads, and restoring the flags when
            # one job ends would change them under the others.
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        s_init, s_eval, s_fl = (fold_seed(seed, i) for i in range(3))
        params0 = init_params(generator(s_init, self.device), self.ae)
        x_eval = image_batch(generator(s_eval, self.device), cfg.eval_batch,
                             size=self.ae.image_size, channels=self.ae.channels)

        measurements: list[tuple[float, float]] = []
        state = {"fit": None, "applied": False, "round": None}

        def hook(rnd: int, params, alloc, stats: RoundStats) -> None:
            noise_seed = fold_seed(s_eval, rnd)   # the round's eval channel draw
            for rho in (float(alloc.rho), *cfg.probe_rhos):
                measurements.append((rho, self._measure(params, x_eval, noise_seed, rho)))
            if rnd + 1 < cfg.refit_after:
                return
            rhos, accs = zip(*measurements)
            state["fit"] = fit_power_law(rhos, accs)
            if cfg.feedback and backend is not None:
                if backend.set_accuracy(state["fit"]) and not state["applied"]:
                    state["applied"] = True
                    state["round"] = rnd

        params, history = run_fl(
            s_fl, params0, self._loss_fn, self._batch_fn, cfg.fl,
            backend=backend, round_hook=hook,
        )
        return SemComJobResult(
            name=cfg.name,
            params=params,
            history=history,
            measurements=measurements,
            accuracy_fit=state["fit"],
            refit_applied=state["applied"],
            refit_round=state["round"],
        )
