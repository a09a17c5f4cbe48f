"""containerd snapshots.v1 gRPC service over the Snapshotter core.

Reference cmd/containerd-nydus-grpc/snapshotter.go:60-94 serves the
containerd snapshots API on a UDS via ``snapshotservice.FromSnapshotter``.
Here the service is hand-wired with grpc generic method handlers over the
protoc-generated messages (no grpcio-tools codegen in the environment), so
the wire format matches containerd's proxy-plugin expectation.
"""

from __future__ import annotations

import logging
import re
from concurrent import futures
from typing import Iterator, Optional

import grpc
from google.protobuf import empty_pb2

from nydus_snapshotter_tpu_torch import trace
from nydus_snapshotter_tpu_torch.api import snapshots_pb2 as pb
from nydus_snapshotter_tpu_torch.api.filters import compile_filters
from nydus_snapshotter_tpu_torch.snapshot import metastore as ms
from nydus_snapshotter_tpu_torch.snapshot.metastore import Info, Usage
from nydus_snapshotter_tpu_torch.snapshot.snapshotter import Snapshotter
from nydus_snapshotter_tpu_torch.utils import errdefs

logger = logging.getLogger(__name__)

SERVICE_NAME = "containerd.services.snapshots.v1.Snapshots"

_KIND_TO_PB = {
    ms.KIND_VIEW: pb.VIEW,
    ms.KIND_ACTIVE: pb.ACTIVE,
    ms.KIND_COMMITTED: pb.COMMITTED,
}
_PB_TO_KIND = {v: k for k, v in _KIND_TO_PB.items()}


def _abort_for(context: grpc.ServicerContext, err: Exception) -> None:
    if isinstance(err, errdefs.NotFound):
        context.abort(grpc.StatusCode.NOT_FOUND, str(err))
    if isinstance(err, errdefs.AlreadyExists):
        context.abort(grpc.StatusCode.ALREADY_EXISTS, str(err))
    if isinstance(err, errdefs.InvalidArgument):
        context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(err))
    if isinstance(err, errdefs.FailedPrecondition):
        context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(err))
    if isinstance(err, errdefs.Unavailable):
        context.abort(grpc.StatusCode.UNAVAILABLE, str(err))
    logger.exception("internal error in snapshots service")
    context.abort(grpc.StatusCode.INTERNAL, str(err))


def _info_to_pb(info: Info) -> pb.Info:
    out = pb.Info(
        name=info.name,
        parent=info.parent,
        kind=_KIND_TO_PB.get(info.kind, pb.UNKNOWN),
        labels=dict(info.labels),
    )
    out.created_at.FromNanoseconds(int(info.created * 1e9))
    out.updated_at.FromNanoseconds(int(info.updated * 1e9))
    return out


def _mounts_to_pb(mounts) -> list[pb.Mount]:
    return [
        pb.Mount(type=m.type, source=m.source, options=list(m.options)) for m in mounts
    ]


class SnapshotsService:
    """Method implementations; one instance wraps one Snapshotter."""

    def __init__(self, sn: Snapshotter):
        self.sn = sn

    # Each handler: (request) -> response, with errdefs mapped to gRPC codes.
    # Every RPC opens a ROOT trace span — the tree a slow pod start hangs
    # off: snapshotter op → metastore txns → daemon mount → blobcache
    # fetches, including background work the prepare board finishes later.

    def Prepare(self, req: pb.PrepareSnapshotRequest, context) -> pb.PrepareSnapshotResponse:
        with trace.span("grpc.Prepare", key=req.key, parent=req.parent):
            try:
                mounts = self.sn.prepare(req.key, req.parent, dict(req.labels))
            except Exception as e:  # noqa: BLE001 - mapped to status codes
                _abort_for(context, e)
        return pb.PrepareSnapshotResponse(mounts=_mounts_to_pb(mounts))

    def View(self, req: pb.ViewSnapshotRequest, context) -> pb.ViewSnapshotResponse:
        with trace.span("grpc.View", key=req.key, parent=req.parent):
            try:
                mounts = self.sn.view(req.key, req.parent, dict(req.labels))
            except Exception as e:
                _abort_for(context, e)
        return pb.ViewSnapshotResponse(mounts=_mounts_to_pb(mounts))

    def Mounts(self, req: pb.MountsRequest, context) -> pb.MountsResponse:
        with trace.span("grpc.Mounts", key=req.key):
            try:
                mounts = self.sn.mounts(req.key)
            except Exception as e:
                _abort_for(context, e)
        return pb.MountsResponse(mounts=_mounts_to_pb(mounts))

    def Commit(self, req: pb.CommitSnapshotRequest, context) -> empty_pb2.Empty:
        with trace.span("grpc.Commit", key=req.key, name=req.name):
            try:
                self.sn.commit(req.name, req.key, dict(req.labels))
            except Exception as e:
                _abort_for(context, e)
        return empty_pb2.Empty()

    def Remove(self, req: pb.RemoveSnapshotRequest, context) -> empty_pb2.Empty:
        with trace.span("grpc.Remove", key=req.key):
            try:
                self.sn.remove(req.key)
            except Exception as e:
                _abort_for(context, e)
        return empty_pb2.Empty()

    def Stat(self, req: pb.StatSnapshotRequest, context) -> pb.StatSnapshotResponse:
        try:
            info = self.sn.stat(req.key)
        except Exception as e:
            _abort_for(context, e)
        return pb.StatSnapshotResponse(info=_info_to_pb(info))

    def Update(self, req: pb.UpdateSnapshotRequest, context) -> pb.UpdateSnapshotResponse:
        try:
            info = Info(
                kind=_PB_TO_KIND.get(req.info.kind, ""),
                name=req.info.name,
                parent=req.info.parent,
                labels=dict(req.info.labels),
            )
            # Pass the mask through untouched: the metastore rejects
            # unsupported paths with InvalidArgument; filtering here would
            # turn an invalid mask into a destructive full replace.
            out = self.sn.update(info, *req.update_mask.paths)
        except Exception as e:
            _abort_for(context, e)
        return pb.UpdateSnapshotResponse(info=_info_to_pb(out))

    def List(self, req: pb.ListSnapshotsRequest, context) -> Iterator[pb.ListSnapshotsResponse]:
        infos: list[pb.Info] = []
        try:
            try:
                match = compile_filters(list(req.filters))
            except (ValueError, re.error) as e:
                # A malformed filter is a caller error, not an internal one.
                raise errdefs.InvalidArgument(f"invalid filter: {e}") from e
            self.sn.walk(
                lambda _sid, info: infos.append(_info_to_pb(info)) if match(info) else None
            )
        except Exception as e:
            _abort_for(context, e)
        # containerd streams in batches; one batch is fine for our sizes.
        if infos:
            yield pb.ListSnapshotsResponse(info=infos)

    def Usage(self, req: pb.UsageRequest, context) -> pb.UsageResponse:
        with trace.span("grpc.Usage", key=req.key):
            try:
                usage: Usage = self.sn.usage(req.key)
            except Exception as e:
                _abort_for(context, e)
        return pb.UsageResponse(size=usage.size, inodes=usage.inodes)

    def Cleanup(self, req: pb.CleanupRequest, context) -> empty_pb2.Empty:
        with trace.span("grpc.Cleanup"):
            try:
                self.sn.cleanup()
            except Exception as e:
                _abort_for(context, e)
        return empty_pb2.Empty()


_METHODS = {
    "Prepare": (pb.PrepareSnapshotRequest, pb.PrepareSnapshotResponse, False),
    "View": (pb.ViewSnapshotRequest, pb.ViewSnapshotResponse, False),
    "Mounts": (pb.MountsRequest, pb.MountsResponse, False),
    "Commit": (pb.CommitSnapshotRequest, empty_pb2.Empty, False),
    "Remove": (pb.RemoveSnapshotRequest, empty_pb2.Empty, False),
    "Stat": (pb.StatSnapshotRequest, pb.StatSnapshotResponse, False),
    "Update": (pb.UpdateSnapshotRequest, pb.UpdateSnapshotResponse, False),
    "List": (pb.ListSnapshotsRequest, pb.ListSnapshotsResponse, True),
    "Usage": (pb.UsageRequest, pb.UsageResponse, False),
    "Cleanup": (pb.CleanupRequest, empty_pb2.Empty, False),
}


def add_snapshots_service(server: grpc.Server, sn: Snapshotter) -> SnapshotsService:
    service = SnapshotsService(sn)
    handlers = {}
    for name, (req_cls, _resp_cls, streaming) in _METHODS.items():
        fn = getattr(service, name)
        if streaming:
            handlers[name] = grpc.unary_stream_rpc_method_handler(
                fn,
                request_deserializer=req_cls.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            )
        else:
            handlers[name] = grpc.unary_unary_rpc_method_handler(
                fn,
                request_deserializer=req_cls.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )
    return service


def worker_count(snapshots_cfg=None) -> int:
    """gRPC handler pool sized to the control plane: with the metastore
    read pool and the prepare fanout absorbing concurrent RPCs, the
    handler pool — not a global metastore lock — is the admission bound,
    so it must be at least as wide as what the control plane can overlap."""
    read_pool = getattr(snapshots_cfg, "read_pool", 8)
    fanout = getattr(snapshots_cfg, "prepare_fanout", 4)
    return max(8, read_pool + fanout)


def serve(
    sn: Snapshotter, address: str, max_workers: Optional[int] = None
) -> grpc.Server:
    """Start the snapshots gRPC server on a UDS path; returns the server."""
    if max_workers is None:
        max_workers = worker_count()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    add_snapshots_service(server, sn)
    server.add_insecure_port(f"unix:{address}")
    server.start()
    return server
