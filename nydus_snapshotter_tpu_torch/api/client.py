"""Client for the snapshots.v1 gRPC service (tests + tooling).

containerd itself is the production client; this mirrors the minimal stub
surface so integration tests can drive the server exactly the way the
proxy plugin would.
"""

from __future__ import annotations

from typing import Optional

import grpc
from google.protobuf import empty_pb2

from nydus_snapshotter_tpu_torch.api import snapshots_pb2 as pb
from nydus_snapshotter_tpu_torch.api.service import SERVICE_NAME, _METHODS


class SnapshotsClient:
    def __init__(self, address: str, timeout: float = 30.0):
        self.channel = grpc.insecure_channel(f"unix:{address}")
        self.timeout = timeout
        self._stubs = {}
        for name, (req_cls, resp_cls, streaming) in _METHODS.items():
            path = f"/{SERVICE_NAME}/{name}"
            if streaming:
                self._stubs[name] = self.channel.unary_stream(
                    path,
                    request_serializer=req_cls.SerializeToString,
                    response_deserializer=resp_cls.FromString,
                )
            else:
                self._stubs[name] = self.channel.unary_unary(
                    path,
                    request_serializer=req_cls.SerializeToString,
                    response_deserializer=resp_cls.FromString,
                )

    def close(self) -> None:
        self.channel.close()

    def _call(self, name: str, req):
        return self._stubs[name](req, timeout=self.timeout)

    def prepare(self, key: str, parent: str = "", labels: Optional[dict] = None):
        resp = self._call(
            "Prepare", pb.PrepareSnapshotRequest(key=key, parent=parent, labels=labels or {})
        )
        return list(resp.mounts)

    def view(self, key: str, parent: str = "", labels: Optional[dict] = None):
        resp = self._call(
            "View", pb.ViewSnapshotRequest(key=key, parent=parent, labels=labels or {})
        )
        return list(resp.mounts)

    def mounts(self, key: str):
        return list(self._call("Mounts", pb.MountsRequest(key=key)).mounts)

    def commit(self, name: str, key: str, labels: Optional[dict] = None) -> None:
        self._call("Commit", pb.CommitSnapshotRequest(name=name, key=key, labels=labels or {}))

    def remove(self, key: str) -> None:
        self._call("Remove", pb.RemoveSnapshotRequest(key=key))

    def stat(self, key: str) -> pb.Info:
        return self._call("Stat", pb.StatSnapshotRequest(key=key)).info

    def update(self, info: pb.Info, *fieldpaths: str) -> pb.Info:
        req = pb.UpdateSnapshotRequest(info=info)
        req.update_mask.paths.extend(fieldpaths)
        return self._call("Update", req).info

    def list(self) -> list[pb.Info]:
        out: list[pb.Info] = []
        for batch in self._call("List", pb.ListSnapshotsRequest()):
            out.extend(batch.info)
        return out

    def usage(self, key: str) -> pb.UsageResponse:
        return self._call("Usage", pb.UsageRequest(key=key))

    def cleanup(self) -> None:
        self._call("Cleanup", pb.CleanupRequest())
