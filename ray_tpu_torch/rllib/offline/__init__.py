"""ray_tpu_torch.rllib.offline — offline-RL data plane (reference:
rllib/offline/ — offline_data.py, json_reader.py, json_writer.py,
offline_env_runner.py).

Offline data is columnar from the moment it is read (one SampleBatch of
contiguous numpy arrays, minibatches sliced by index), so the learner's
update consumes it with no per-row Python work.  Reading flows through
ray_tpu_torch.data when given a Dataset or parquet; writing produces JSONL
shards any Dataset reader can ingest.
"""

from ray_tpu_torch.rllib.offline.estimators import (
    ImportanceSampling,
    OffPolicyEstimator,
    WeightedImportanceSampling,
)
from ray_tpu_torch.rllib.offline.offline_data import (
    JsonWriter,
    OfflineData,
    record_rollouts,
)

__all__ = [
    "OfflineData",
    "JsonWriter",
    "record_rollouts",
    "OffPolicyEstimator",
    "ImportanceSampling",
    "WeightedImportanceSampling",
]
