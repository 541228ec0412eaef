"""Hyperparameter tuning: ``tune.run`` with search spaces, ASHA and PBT,
and the ``Trainer``'s report and checkpoint relay.

Counterpart of ``ray_lightning_tpu/tune/`` (the reference's
``ray_lightning/tune.py`` and the ``ray.tune`` API its examples use):
trial resources in GPUs, the report and checkpoint callbacks, and a
runner of its own, so a sweep needs no Ray; the callbacks also deliver
into a live Ray Tune session when Ray is installed (tune/ray_bridge.py).
A trial trains in process, on a card leased from this process's cards,
or in ``RayPlugin`` / ``RayShardedPlugin`` workers, whose reports and
checkpoints come back through the worker queue.
"""

from ray_lightning_tpu_torch.tune.integration import (
    TrialResources,
    TuneReportCallback,
    TuneReportCheckpointCallback,
    _TuneCheckpointCallback,  # noqa: F401  (tested internal)
    get_tune_resources,
)
from ray_lightning_tpu_torch.tune.runner import (
    ExperimentAnalysis,
    Trial,
    run,
)
from ray_lightning_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_lightning_tpu_torch.tune.search import (
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_lightning_tpu_torch.tune.session import (
    checkpoint_dir,
    get_trial_dir,
    get_trial_id,
    report,
)

#: the reference's ``TUNE_INSTALLED`` guard (``tune.py:13-27``): the
#: built-in runner is always here; the flag stays for code written
#: against that pattern
TUNE_INSTALLED = True

__all__ = [
    "TrialResources",
    "TuneReportCallback",
    "TuneReportCheckpointCallback",
    "get_tune_resources",
    "ExperimentAnalysis",
    "Trial",
    "run",
    "ASHAScheduler",
    "FIFOScheduler",
    "PopulationBasedTraining",
    "TrialScheduler",
    "choice",
    "grid_search",
    "loguniform",
    "randint",
    "uniform",
    "checkpoint_dir",
    "get_trial_dir",
    "get_trial_id",
    "report",
    "TUNE_INSTALLED",
]
