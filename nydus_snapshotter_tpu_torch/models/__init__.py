"""On-disk / on-wire data models: RAFS bootstraps, nydus-tar framing, TOC."""
