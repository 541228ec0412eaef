"""Trial schedulers: FIFO, ASHA (asynchronous successive halving), PBT.

Counterpart of ``ray_lightning_tpu/tune/schedulers.py``.  The reference
leaves scheduling to Ray Tune (SURVEY.md §3.3); the runner here stands
alone, so the two schedulers the reference's docs and examples lean on
are built in.  A decision is made inside ``report``, on the reporting
trial's thread, which waits for it: trials never preempt each other
mid-step.  One sequence of results gives the JAX package's decisions
(PBT draws from ``random.Random(seed)`` in its order).
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ray_lightning_tpu_torch.tune.search import Domain

CONTINUE = "CONTINUE"
STOP = "STOP"
EXPLOIT = "EXPLOIT"


@dataclass
class Decision:
    action: str = CONTINUE
    #: EXPLOIT (PBT): restart from this checkpoint with this config
    config: Optional[dict] = None
    checkpoint: Optional[str] = None


class TrialScheduler:
    """Sees every report and decides the trial's fate."""

    def __init__(self, metric: str = "loss", mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.metric = metric
        self.mode = mode
        self._lock = threading.Lock()

    def _score(self, metrics: dict) -> Optional[float]:
        """The metric with higher better, or ``None`` when absent."""
        v = metrics.get(self.metric)
        if v is None:
            return None
        v = float(v)
        return -v if self.mode == "min" else v

    def on_result(self, trial, metrics: dict) -> Decision:
        return Decision(CONTINUE)

    def on_trial_complete(self, trial) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    """Runs every trial to completion."""


class ASHAScheduler(TrialScheduler):
    """Asynchronous Successive Halving.

    Rungs sit at ``grace_period * reduction_factor**k`` iterations
    (``training_iteration``).  A trial passes a rung only if its score is
    in the top ``1 / reduction_factor`` of the scores recorded at that
    rung so far: early trials pass until enough competitors exist.  A
    trial meets each rung once, at its first report at or past it.
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4):
        super().__init__(metric, mode)
        self.max_t = max_t
        self.grace_period = max(1, grace_period)
        self.rf = max(2, reduction_factor)
        self._rungs: "dict[int, list[float]]" = {}
        #: milestone -> the trials already scored there
        self._recorded: "dict[int, set[str]]" = {}
        self._milestones = []
        t = self.grace_period
        while t < max_t:
            self._milestones.append(t)
            t *= self.rf

    def on_result(self, trial, metrics: dict) -> Decision:
        it = int(metrics.get("training_iteration", 0))
        score = self._score(metrics)
        if score is None:
            return Decision(CONTINUE)
        if it >= self.max_t:
            return Decision(STOP)
        with self._lock:
            for ms in self._milestones:
                if it < ms:
                    break
                seen = self._recorded.setdefault(ms, set())
                if trial.trial_id in seen:
                    continue
                seen.add(trial.trial_id)
                rung = self._rungs.setdefault(ms, [])
                rung.append(score)
                k = max(1, len(rung) // self.rf)
                cutoff = sorted(rung, reverse=True)[k - 1]
                if score < cutoff:
                    return Decision(STOP)
        return Decision(CONTINUE)


class PopulationBasedTraining(TrialScheduler):
    """PBT: every ``perturbation_interval`` iterations, a trial in the
    bottom quantile restarts from a top-quantile trial's latest
    checkpoint with a perturbed copy of that trial's config.

    ``hyperparam_mutations`` maps a config key to a list of values (one
    is drawn), a ``Domain`` (resampled) or a callable (called); other
    numeric keys named there are scaled by 0.8 or 1.2.  The trainable
    must save checkpoints through ``tune.checkpoint_dir`` (as
    ``TuneReportCheckpointCallback`` does) and take a ``checkpoint_dir``
    argument to restart from one.
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[dict] = None,
                 quantile_fraction: float = 0.25, seed: int = 0):
        super().__init__(metric, mode)
        self.interval = max(1, perturbation_interval)
        self.mutations = dict(hyperparam_mutations or {})
        self.quantile = quantile_fraction
        self._rng = random.Random(seed)
        #: trial_id -> (score, config, checkpoint)
        self._population: "dict[str, tuple[float, dict, Optional[str]]]" \
            = {}

    def _perturb(self, config: dict) -> dict:
        out = dict(config)
        for key, mut in self.mutations.items():
            if isinstance(mut, Domain):
                out[key] = mut.sample(
                    np.random.default_rng(self._rng.randrange(2**31)))
            elif isinstance(mut, list):
                out[key] = self._rng.choice(mut)
            elif callable(mut):
                out[key] = mut()
            elif isinstance(out.get(key), (int, float)):
                factor = self._rng.choice([0.8, 1.2])
                out[key] = type(out[key])(out[key] * factor)
        return out

    def on_result(self, trial, metrics: dict) -> Decision:
        it = int(metrics.get("training_iteration", 0))
        score = self._score(metrics)
        if score is None:
            return Decision(CONTINUE)
        with self._lock:
            self._population[trial.trial_id] = (
                score, dict(trial.config), trial.latest_checkpoint)
            if it % self.interval != 0 or len(self._population) < 2:
                return Decision(CONTINUE)
            ranked = sorted(self._population.items(),
                            key=lambda kv: kv[1][0], reverse=True)
            n = len(ranked)
            k = max(1, int(n * self.quantile))
            bottom_ids = {tid for tid, _ in ranked[-k:]}
            if trial.trial_id not in bottom_ids or n <= k:
                return Decision(CONTINUE)
            donor_id, (_score, dconfig, dckpt) = ranked[
                self._rng.randrange(min(k, n - k))]
            if donor_id == trial.trial_id or dckpt is None:
                return Decision(CONTINUE)
            return Decision(EXPLOIT, config=self._perturb(dconfig),
                            checkpoint=dckpt)


__all__ = ["ASHAScheduler", "CONTINUE", "Decision", "EXPLOIT",
           "FIFOScheduler", "PopulationBasedTraining", "STOP",
           "TrialScheduler"]
