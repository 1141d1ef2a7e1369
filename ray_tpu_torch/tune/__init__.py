"""ray_tpu_torch.tune — hyperparameter tuning (reference: python/ray/tune).

Trials are actors placed by the cluster scheduler; searchers generate
configs; schedulers (ASHA/PBT/median-stopping) make early-stop and
exploit decisions; experiment state persists for resume.
"""

from ray_tpu_torch.tune.sample import (
    choice,
    grid_search,
    loguniform,
    qloguniform,
    qrandint,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.schedulers import (
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    HyperBandForBOHB,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator
from ray_tpu_torch.tune.search.searcher import ConcurrencyLimiter, Searcher
from ray_tpu_torch.tune.search.bohb import TuneBOHB
from ray_tpu_torch.tune.search.tpe import TPESearcher
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.trainable import Trainable, with_parameters, with_resources
from ray_tpu_torch.tune.trial import Trial
from ray_tpu_torch.tune.tuner import TuneConfig, Tuner

# report/get_checkpoint are shared with ray_tpu_torch.train (same session plumbing).
from ray_tpu_torch.train.context import get_checkpoint, report

ASHAScheduler = AsyncHyperBandScheduler

__all__ = [
    "Tuner",
    "TuneConfig",
    "ResultGrid",
    "Trainable",
    "Trial",
    "report",
    "get_checkpoint",
    "with_parameters",
    "with_resources",
    # sample
    "choice",
    "grid_search",
    "uniform",
    "quniform",
    "loguniform",
    "qloguniform",
    "randint",
    "qrandint",
    "randn",
    "sample_from",
    # search
    "Searcher",
    "ConcurrencyLimiter",
    "BasicVariantGenerator",
    "TPESearcher",
    "TuneBOHB",
    # schedulers
    "TrialScheduler",
    "FIFOScheduler",
    "AsyncHyperBandScheduler",
    "ASHAScheduler",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "PB2",
    "HyperBandForBOHB",
]
