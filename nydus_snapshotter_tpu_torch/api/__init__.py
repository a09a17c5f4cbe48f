"""The snapshotter API surface (containerd snapshots.v1-compatible): the
list filters (:mod:`.filters`), the generated messages
(:mod:`.snapshots_pb2`, the reference's descriptor byte for byte), the
gRPC servicer (:mod:`.service`) and its client (:mod:`.client`)."""
