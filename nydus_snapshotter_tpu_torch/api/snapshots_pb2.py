# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: snapshots.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import empty_pb2 as google_dot_protobuf_dot_empty__pb2
from google.protobuf import field_mask_pb2 as google_dot_protobuf_dot_field__mask__pb2
from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fsnapshots.proto\x12 containerd.services.snapshots.v1\x1a\x1bgoogle/protobuf/empty.proto\x1a google/protobuf/field_mask.proto\x1a\x1fgoogle/protobuf/timestamp.proto\"\xcf\x01\n\x16PrepareSnapshotRequest\x12\x13\n\x0bsnapshotter\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\x0e\n\x06parent\x18\x03 \x01(\t\x12T\n\x06labels\x18\x04 \x03(\x0b\x32\x44.containerd.services.snapshots.v1.PrepareSnapshotRequest.LabelsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"R\n\x17PrepareSnapshotResponse\x12\x37\n\x06mounts\x18\x01 \x03(\x0b\x32\'.containerd.services.snapshots.v1.Mount\"\xc9\x01\n\x13ViewSnapshotRequest\x12\x13\n\x0bsnapshotter\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\x0e\n\x06parent\x18\x03 \x01(\t\x12Q\n\x06labels\x18\x04 \x03(\x0b\x32\x41.containerd.services.snapshots.v1.ViewSnapshotRequest.LabelsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"O\n\x14ViewSnapshotResponse\x12\x37\n\x06mounts\x18\x01 \x03(\x0b\x32\'.containerd.services.snapshots.v1.Mount\"1\n\rMountsRequest\x12\x13\n\x0bsnapshotter\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\"I\n\x0eMountsResponse\x12\x37\n\x06mounts\x18\x01 \x03(\x0b\x32\'.containerd.services.snapshots.v1.Mount\"F\n\x05Mount\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x0e\n\x06source\x18\x02 \x01(\t\x12\x0e\n\x06target\x18\x03 \x01(\t\x12\x0f\n\x07options\x18\x04 \x03(\t\"\xcb\x01\n\x15\x43ommitSnapshotRequest\x12\x13\n\x0bsnapshotter\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0b\n\x03key\x18\x03 \x01(\t\x12S\n\x06labels\x18\x04 \x03(\x0b\x32\x43.containerd.services.snapshots.v1.CommitSnapshotRequest.LabelsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"9\n\x15RemoveSnapshotRequest\x12\x13\n\x0bsnapshotter\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\"7\n\x13StatSnapshotRequest\x12\x13\n\x0bsnapshotter\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\"\xad\x02\n\x04Info\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0e\n\x06parent\x18\x02 \x01(\t\x12\x34\n\x04kind\x18\x03 \x01(\x0e\x32&.containerd.services.snapshots.v1.Kind\x12.\n\ncreated_at\x18\x04 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12.\n\nupdated_at\x18\x05 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x42\n\x06labels\x18\x06 \x03(\x0b\x32\x32.containerd.services.snapshots.v1.Info.LabelsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"L\n\x14StatSnapshotResponse\x12\x34\n\x04info\x18\x01 \x01(\x0b\x32&.containerd.services.snapshots.v1.Info\"\x93\x01\n\x15UpdateSnapshotRequest\x12\x13\n\x0bsnapshotter\x18\x01 \x01(\t\x12\x34\n\x04info\x18\x02 \x01(\x0b\x32&.containerd.services.snapshots.v1.Info\x12/\n\x0bupdate_mask\x18\x03 \x01(\x0b\x32\x1a.google.protobuf.FieldMask\"N\n\x16UpdateSnapshotResponse\x12\x34\n\x04info\x18\x01 \x01(\x0b\x32&.containerd.services.snapshots.v1.Info\"<\n\x14ListSnapshotsRequest\x12\x13\n\x0bsnapshotter\x18\x01 \x01(\t\x12\x0f\n\x07\x66ilters\x18\x02 \x03(\t\"M\n\x15ListSnapshotsResponse\x12\x34\n\x04info\x18\x01 \x03(\x0b\x32&.containerd.services.snapshots.v1.Info\"0\n\x0cUsageRequest\x12\x13\n\x0bsnapshotter\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\"-\n\rUsageResponse\x12\x0c\n\x04size\x18\x01 \x01(\x03\x12\x0e\n\x06inodes\x18\x02 \x01(\x03\"%\n\x0e\x43leanupRequest\x12\x13\n\x0bsnapshotter\x18\x01 \x01(\t*8\n\x04Kind\x12\x0b\n\x07UNKNOWN\x10\x00\x12\x08\n\x04VIEW\x10\x01\x12\n\n\x06\x41\x43TIVE\x10\x02\x12\r\n\tCOMMITTED\x10\x03\x32\xd3\x08\n\tSnapshots\x12~\n\x07Prepare\x12\x38.containerd.services.snapshots.v1.PrepareSnapshotRequest\x1a\x39.containerd.services.snapshots.v1.PrepareSnapshotResponse\x12u\n\x04View\x12\x35.containerd.services.snapshots.v1.ViewSnapshotRequest\x1a\x36.containerd.services.snapshots.v1.ViewSnapshotResponse\x12k\n\x06Mounts\x12/.containerd.services.snapshots.v1.MountsRequest\x1a\x30.containerd.services.snapshots.v1.MountsResponse\x12Y\n\x06\x43ommit\x12\x37.containerd.services.snapshots.v1.CommitSnapshotRequest\x1a\x16.google.protobuf.Empty\x12Y\n\x06Remove\x12\x37.containerd.services.snapshots.v1.RemoveSnapshotRequest\x1a\x16.google.protobuf.Empty\x12u\n\x04Stat\x12\x35.containerd.services.snapshots.v1.StatSnapshotRequest\x1a\x36.containerd.services.snapshots.v1.StatSnapshotResponse\x12{\n\x06Update\x12\x37.containerd.services.snapshots.v1.UpdateSnapshotRequest\x1a\x38.containerd.services.snapshots.v1.UpdateSnapshotResponse\x12y\n\x04List\x12\x36.containerd.services.snapshots.v1.ListSnapshotsRequest\x1a\x37.containerd.services.snapshots.v1.ListSnapshotsResponse0\x01\x12h\n\x05Usage\x12..containerd.services.snapshots.v1.UsageRequest\x1a/.containerd.services.snapshots.v1.UsageResponse\x12S\n\x07\x43leanup\x12\x30.containerd.services.snapshots.v1.CleanupRequest\x1a\x16.google.protobuf.Emptyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'snapshots_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PREPARESNAPSHOTREQUEST_LABELSENTRY._options = None
  _PREPARESNAPSHOTREQUEST_LABELSENTRY._serialized_options = b'8\001'
  _VIEWSNAPSHOTREQUEST_LABELSENTRY._options = None
  _VIEWSNAPSHOTREQUEST_LABELSENTRY._serialized_options = b'8\001'
  _COMMITSNAPSHOTREQUEST_LABELSENTRY._options = None
  _COMMITSNAPSHOTREQUEST_LABELSENTRY._serialized_options = b'8\001'
  _INFO_LABELSENTRY._options = None
  _INFO_LABELSENTRY._serialized_options = b'8\001'
  _KIND._serialized_start=2137
  _KIND._serialized_end=2193
  _PREPARESNAPSHOTREQUEST._serialized_start=150
  _PREPARESNAPSHOTREQUEST._serialized_end=357
  _PREPARESNAPSHOTREQUEST_LABELSENTRY._serialized_start=312
  _PREPARESNAPSHOTREQUEST_LABELSENTRY._serialized_end=357
  _PREPARESNAPSHOTRESPONSE._serialized_start=359
  _PREPARESNAPSHOTRESPONSE._serialized_end=441
  _VIEWSNAPSHOTREQUEST._serialized_start=444
  _VIEWSNAPSHOTREQUEST._serialized_end=645
  _VIEWSNAPSHOTREQUEST_LABELSENTRY._serialized_start=312
  _VIEWSNAPSHOTREQUEST_LABELSENTRY._serialized_end=357
  _VIEWSNAPSHOTRESPONSE._serialized_start=647
  _VIEWSNAPSHOTRESPONSE._serialized_end=726
  _MOUNTSREQUEST._serialized_start=728
  _MOUNTSREQUEST._serialized_end=777
  _MOUNTSRESPONSE._serialized_start=779
  _MOUNTSRESPONSE._serialized_end=852
  _MOUNT._serialized_start=854
  _MOUNT._serialized_end=924
  _COMMITSNAPSHOTREQUEST._serialized_start=927
  _COMMITSNAPSHOTREQUEST._serialized_end=1130
  _COMMITSNAPSHOTREQUEST_LABELSENTRY._serialized_start=312
  _COMMITSNAPSHOTREQUEST_LABELSENTRY._serialized_end=357
  _REMOVESNAPSHOTREQUEST._serialized_start=1132
  _REMOVESNAPSHOTREQUEST._serialized_end=1189
  _STATSNAPSHOTREQUEST._serialized_start=1191
  _STATSNAPSHOTREQUEST._serialized_end=1246
  _INFO._serialized_start=1249
  _INFO._serialized_end=1550
  _INFO_LABELSENTRY._serialized_start=312
  _INFO_LABELSENTRY._serialized_end=357
  _STATSNAPSHOTRESPONSE._serialized_start=1552
  _STATSNAPSHOTRESPONSE._serialized_end=1628
  _UPDATESNAPSHOTREQUEST._serialized_start=1631
  _UPDATESNAPSHOTREQUEST._serialized_end=1778
  _UPDATESNAPSHOTRESPONSE._serialized_start=1780
  _UPDATESNAPSHOTRESPONSE._serialized_end=1858
  _LISTSNAPSHOTSREQUEST._serialized_start=1860
  _LISTSNAPSHOTSREQUEST._serialized_end=1920
  _LISTSNAPSHOTSRESPONSE._serialized_start=1922
  _LISTSNAPSHOTSRESPONSE._serialized_end=1999
  _USAGEREQUEST._serialized_start=2001
  _USAGEREQUEST._serialized_end=2049
  _USAGERESPONSE._serialized_start=2051
  _USAGERESPONSE._serialized_end=2096
  _CLEANUPREQUEST._serialized_start=2098
  _CLEANUPREQUEST._serialized_end=2135
  _SNAPSHOTS._serialized_start=2196
  _SNAPSHOTS._serialized_end=3303
# @@protoc_insertion_point(module_scope)
