"""Developer tooling shipped with the repo (not part of the runtime API)."""
