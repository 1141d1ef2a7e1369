"""ray_tpu_torch.serve — model serving.  Ported so far: the LLM engine
(``serve.llm``) and the typed serve errors; the controller, replicas,
router and proxy are not ported yet."""

from ray_tpu_torch.serve.exceptions import RequestShedError

__all__ = ["RequestShedError"]
