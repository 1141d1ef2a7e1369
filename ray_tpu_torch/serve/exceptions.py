"""Typed serve-plane errors (the port's own copy of
``ray_tpu/serve/exceptions.py``)."""

from __future__ import annotations


class RequestShedError(RuntimeError):
    """The request was shed by an overload bound (engine waiting queue or
    brownout) — retryable after backoff."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s

    def __reduce__(self):
        return (RequestShedError, (str(self), self.retry_after_s))
