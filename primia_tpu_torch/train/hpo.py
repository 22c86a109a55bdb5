"""Self-contained hyperparameter search (the reference's Optuna role).

Port of ``primia_tpu/train/hpo.py``, a copy: the study is pure Python,
driven by ``random.Random(seed)``, so with the same seed and the same
reported values it suggests the same parameters and takes the same prune
decisions as the JAX package's, and each package resumes the other's
JSON study file.

The reference drives HPO with an Optuna study over SQLite
(``torchlib/find_config.py:17-229``: TPE sampler + median pruner,
``optuna_trial.report`` hooks in the train loop, ``train.py:508-515``).
This module implements the same surface (``suggest_*`` methods,
``report``/``should_prune``, persistent resumable storage) with:

* a TPE-lite sampler: random for ``n_startup`` trials, then parameters
  are drawn by perturbing a uniformly chosen trial from the top
  ``gamma`` quantile (kernel-density-by-resampling, the heart of TPE);
* a median pruner: a trial is pruned at step ``s`` when its value is
  below the median of all other trials' values at the same step (after
  ``n_warmup_steps``, and once ``n_startup // 2`` peers reported there);
* a JSON study file instead of SQLite (single writer, replaced
  atomically).

The train loops only see the duck-typed trial object, exactly as with
Optuna (``train/loop.py`` and ``parallel/federated.py`` call
``report``/``should_prune`` and raise :class:`TrialPruned`).
"""

from __future__ import annotations

import json
import math
import os
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


class TrialPruned(Exception):
    """Raised inside an objective to abandon an unpromising trial."""


@dataclass
class TrialRecord:
    number: int
    params: Dict[str, Any] = field(default_factory=dict)
    intermediate: Dict[str, float] = field(default_factory=dict)  # step -> value
    value: Optional[float] = None
    state: str = "running"  # running | complete | pruned | failed


class Trial:
    """Optuna-compatible trial handle (the subset the reference uses)."""

    def __init__(self, study: "Study", record: TrialRecord):
        self._study = study
        self._rec = record
        self._should_prune = False

    @property
    def number(self) -> int:
        return self._rec.number

    @property
    def params(self) -> Dict[str, Any]:
        return dict(self._rec.params)

    # ------------------------------------------------------- suggest_*

    def _suggest(self, name: str, draw) -> Any:
        if name in self._rec.params:
            return self._rec.params[name]
        v = self._study._sample(name, draw)
        self._rec.params[name] = v
        return v

    def suggest_float(self, name, low, high, *, log: bool = False):
        if log:
            return self.suggest_loguniform(name, low, high)
        return self._suggest(
            name, lambda rng, base=None: _perturb_uniform(rng, base, low, high)
        )

    def suggest_loguniform(self, name, low, high):
        def draw(rng, base=None):
            lo, hi = math.log(low), math.log(high)
            x = _perturb_uniform(rng, math.log(base) if base else None, lo, hi)
            return min(max(math.exp(x), low), high)  # exp/log roundoff

        return self._suggest(name, draw)

    def suggest_int(self, name, low, high):
        def draw(rng, base=None):
            v = _perturb_uniform(rng, float(base) if base is not None else None,
                                 low, high)
            return int(round(v))

        return self._suggest(name, draw)

    def suggest_categorical(self, name, choices):
        choices = list(choices)

        def draw(rng, base=None):
            if base is not None and rng.random() < 0.7 and base in choices:
                return base
            return rng.choice(choices)

        return self._suggest(name, draw)

    # -------------------------------------------------------- pruning

    def report(self, value: float, step: int) -> None:
        self._rec.intermediate[str(int(step))] = float(value)
        self._should_prune = self._study._prune_decision(self._rec, int(step))

    def should_prune(self) -> bool:
        return self._should_prune


def _perturb_uniform(rng, base, low, high):
    if base is None:
        return rng.uniform(low, high)
    # kernel around the good value: sigma = 20% of the range
    sigma = 0.2 * (high - low)
    return min(max(rng.gauss(base, sigma), low), high)


class Study:
    """Maximizing study with JSON persistence.

    ``storage`` mirrors Optuna's sqlite path role; an existing file is
    loaded so interrupted searches resume (``find_config.py:214-219``
    uses ``load_if_exists=True``).
    """

    def __init__(self, storage: str = "model_weights/hpo_study.json",
                 *, n_startup: int = 10, gamma: float = 0.3,
                 n_warmup_steps: int = 5, seed: Optional[int] = None):
        self.storage = Path(storage)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_warmup_steps = n_warmup_steps
        self._rng = random.Random(seed)
        self.trials: List[TrialRecord] = []
        if self.storage.is_file():
            data = json.loads(self.storage.read_text())
            self.trials = [TrialRecord(**t) for t in data["trials"]]

    # ------------------------------------------------------- sampling

    def _good_trials(self) -> List[TrialRecord]:
        done = [t for t in self.trials if t.state == "complete" and t.value is not None]
        done.sort(key=lambda t: t.value, reverse=True)
        k = max(1, int(len(done) * self.gamma))
        return done[:k]

    def _sample(self, name: str, draw) -> Any:
        done = [t for t in self.trials if t.state == "complete"]
        if len(done) < self.n_startup:
            return draw(self._rng, None)
        good = [t for t in self._good_trials() if name in t.params]
        base = self._rng.choice(good).params[name] if good else None
        return draw(self._rng, base)

    # -------------------------------------------------------- pruning

    def _prune_decision(self, rec: TrialRecord, step: int) -> bool:
        if step < self.n_warmup_steps:
            return False
        peers = []
        for t in self.trials:
            if t.number != rec.number and str(step) in t.intermediate:
                peers.append(t.intermediate[str(step)])
        if len(peers) < max(1, self.n_startup // 2):
            return False
        peers.sort()
        median = peers[len(peers) // 2]
        return rec.intermediate[str(step)] < median

    # ------------------------------------------------------- running

    def ask(self) -> Trial:
        rec = TrialRecord(number=len(self.trials))
        self.trials.append(rec)
        return Trial(self, rec)

    def tell(self, trial: Trial, value: Optional[float], state: str = "complete"):
        trial._rec.value = None if value is None else float(value)
        trial._rec.state = state
        self._save()

    def optimize(self, objective, n_trials: int, *, catch=()):
        for _ in range(n_trials):
            trial = self.ask()
            try:
                value = objective(trial)
                self.tell(trial, value, "complete")
            except TrialPruned:
                steps = trial._rec.intermediate
                last = steps[max(steps, key=int)] if steps else None
                self.tell(trial, last, "pruned")
            except catch:
                self.tell(trial, None, "failed")
        return self.best_trial

    @property
    def best_trial(self) -> Optional[TrialRecord]:
        done = [t for t in self.trials
                if t.state in ("complete", "pruned") and t.value is not None]
        return max(done, key=lambda t: t.value) if done else None

    def _save(self):
        if self.storage.parent and not self.storage.parent.is_dir():
            self.storage.parent.mkdir(parents=True, exist_ok=True)
        payload = {"trials": [t.__dict__ for t in self.trials]}
        tmp = self.storage.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload, indent=1))
        os.replace(tmp, self.storage)
