"""Error types + predicates (reference pkg/errdefs/errors.go)."""

from __future__ import annotations

import errno


class NydusError(Exception):
    """Base class for framework errors."""


class AlreadyExists(NydusError):
    pass


class NotFound(NydusError):
    pass


class ConnectionClosed(NydusError):
    pass


class InvalidArgument(NydusError):
    pass


class Unavailable(NydusError):
    pass


class FailedPrecondition(NydusError):
    pass


def is_already_exists(err: BaseException) -> bool:
    return isinstance(err, (AlreadyExists, FileExistsError)) or (
        isinstance(err, OSError) and err.errno == errno.EEXIST
    )


def is_not_found(err: BaseException) -> bool:
    return isinstance(err, (NotFound, FileNotFoundError, KeyError)) or (
        isinstance(err, OSError) and err.errno == errno.ENOENT
    )


def is_connection_closed(err: BaseException) -> bool:
    return isinstance(err, (ConnectionClosed, BrokenPipeError, ConnectionResetError)) or (
        isinstance(err, OSError) and err.errno in (errno.EPIPE, errno.ECONNRESET)
    )


def is_erofs_mounted(err: BaseException) -> bool:
    return isinstance(err, OSError) and err.errno == errno.EBUSY
