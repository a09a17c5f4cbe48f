"""TOML parser compatibility: stdlib ``tomllib`` (3.11+) with a fallback
to the API-identical ``tomli`` backport on older interpreters.

Import ``tomllib`` from here instead of directly — a missing stdlib
module must degrade to the baked-in backport, not take the whole config
layer (and everything importing it) down with an ImportError.
"""

try:  # pragma: no cover - which branch runs depends on the interpreter
    import tomllib  # noqa: F401
except ModuleNotFoundError:  # Python < 3.11
    import tomli as tomllib  # noqa: F401

__all__ = ["tomllib"]
