"""The snapshotter API surface. Only the list filters
(:mod:`nydus_snapshotter_tpu_torch.api.filters`) are ported so far; the
gRPC service and client come with the control plane."""
