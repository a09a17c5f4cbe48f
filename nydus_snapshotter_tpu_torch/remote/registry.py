"""OCI descriptors: the one piece of the reference package's
``remote/registry.py`` (the OCI distribution v2 client) that the port
carries so far, for the bootstrap-layer encryption of
``encryption/encryption.py``. The resolver, fetcher, pusher and their
auth arrive with the rest of the read path (ROADMAP Queue A item 12).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional


@dataclass
class Descriptor:
    media_type: str
    digest: str
    size: int
    annotations: dict = field(default_factory=dict)
    urls: list = field(default_factory=list)
    platform: Optional[dict] = None

    @classmethod
    def from_json(cls, obj: Mapping) -> "Descriptor":
        # Registry responses are untrusted: missing/mistyped fields must
        # surface as ValueError (the parser contract fuzzed in
        # tests/test_fuzz_parsers.py), never KeyError/TypeError.
        digest = obj.get("digest")
        if not isinstance(digest, str) or not digest:
            raise ValueError("descriptor missing string 'digest'")
        size = obj.get("size", 0)
        if isinstance(size, bool) or not isinstance(size, int):
            raise ValueError(f"descriptor size not an integer: {size!r}")
        annotations = obj.get("annotations") or {}
        urls = obj.get("urls") or []
        platform = obj.get("platform")
        if not isinstance(annotations, Mapping):
            raise ValueError("descriptor annotations not an object")
        if not isinstance(urls, list):
            raise ValueError("descriptor urls not a list")
        if platform is not None and not isinstance(platform, Mapping):
            raise ValueError("descriptor platform not an object")
        media_type = obj.get("mediaType", "")
        if not isinstance(media_type, str):
            raise ValueError("descriptor mediaType not a string")
        return cls(
            media_type=media_type,
            digest=digest,
            size=size,
            annotations=dict(annotations),
            urls=list(urls),
            platform=dict(platform) if platform is not None else None,
        )

    def to_json(self) -> dict:
        out: dict = {"mediaType": self.media_type, "digest": self.digest, "size": self.size}
        if self.annotations:
            out["annotations"] = self.annotations
        if self.urls:
            out["urls"] = self.urls
        if self.platform:
            out["platform"] = self.platform
        return out
