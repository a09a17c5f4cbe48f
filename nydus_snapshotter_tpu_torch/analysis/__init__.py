"""Concurrency analysis: the opt-in runtime lockset race and lock-order
detector (:mod:`.runtime`, ``NTPU_ANALYZE=1``). The static detectors of
the reference package's ``analysis/`` are not part of this package."""
