from nydus_snapshotter_tpu_torch.pprof.listener import new_pprof_http_listener

__all__ = ["new_pprof_http_listener"]
