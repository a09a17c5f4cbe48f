"""Docker image reference parsing/normalization.

Replaces the distribution/reference dependency the reference leans on
(pkg/remote/remote.go:101-104, pkg/resolve/resolver.go:35-44): normalize a
ref like ``ubuntu:22.04`` to ``docker.io/library/ubuntu:22.04``, split out
domain/path/tag/digest.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

DEFAULT_DOMAIN = "docker.io"
LEGACY_DEFAULT_DOMAIN = "index.docker.io"
OFFICIAL_REPO_PREFIX = "library/"
DEFAULT_TAG = "latest"

_TAG_RE = re.compile(r"^[\w][\w.-]{0,127}$")
_DIGEST_RE = re.compile(r"^[a-z0-9]+(?:[.+_-][a-z0-9]+)*:[0-9a-fA-F]{32,}$")


class InvalidReference(ValueError):
    pass


@dataclass(frozen=True)
class ParsedReference:
    domain: str
    path: str
    tag: Optional[str] = None
    digest: Optional[str] = None

    @property
    def name(self) -> str:
        return f"{self.domain}/{self.path}"

    @property
    def familiar(self) -> str:
        out = self.name
        if self.tag:
            out += f":{self.tag}"
        if self.digest:
            out += f"@{self.digest}"
        return out

    def __str__(self) -> str:  # canonical form
        return self.familiar


def _split_domain(name: str) -> tuple[str, str]:
    """Split a name into (domain, remainder) using docker's heuristic: the
    first component is a domain iff it contains '.' or ':' or is
    'localhost'."""
    i = name.find("/")
    if i == -1:
        return DEFAULT_DOMAIN, name
    first = name[:i]
    if "." in first or ":" in first or first == "localhost":
        return first, name[i + 1 :]
    return DEFAULT_DOMAIN, name


def parse_docker_ref(ref: str) -> ParsedReference:
    """Normalized parse (distribution ParseDockerRef semantics)."""
    if not ref or ref != ref.strip():
        raise InvalidReference(f"invalid reference {ref!r}")

    digest = None
    if "@" in ref:
        ref, digest = ref.rsplit("@", 1)
        if not _DIGEST_RE.match(digest):
            raise InvalidReference(f"invalid digest in reference {ref!r}")

    domain, remainder = _split_domain(ref)

    tag = None
    # A ':' after the last '/' is a tag separator (not a port).
    last_slash = remainder.rfind("/")
    colon = remainder.rfind(":")
    if colon > last_slash:
        remainder, tag = remainder[:colon], remainder[colon + 1 :]
        if not _TAG_RE.match(tag):
            raise InvalidReference(f"invalid tag {tag!r}")

    if not remainder:
        raise InvalidReference(f"empty repository path in {ref!r}")
    if domain in (DEFAULT_DOMAIN, LEGACY_DEFAULT_DOMAIN):
        domain = DEFAULT_DOMAIN
        if "/" not in remainder:
            remainder = OFFICIAL_REPO_PREFIX + remainder

    if not re.match(r"^[a-z0-9]+(?:(?:[._]|__|[-]+)[a-z0-9]+)*(?:/[a-z0-9]+(?:(?:[._]|__|[-]+)[a-z0-9]+)*)*$", remainder):
        raise InvalidReference(f"invalid repository path {remainder!r}")

    if digest is None and tag is None:
        tag = DEFAULT_TAG
    return ParsedReference(domain=domain, path=remainder, tag=tag, digest=digest)


def registry_host(domain: str) -> str:
    """Registry endpoint host for a reference domain (docker.io ->
    registry-1.docker.io, the containerd default-registry rewrite)."""
    if domain == DEFAULT_DOMAIN:
        return "registry-1.docker.io"
    return domain
