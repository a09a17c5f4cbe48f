from nydus_snapshotter_tpu_torch.fusedev.session import FuseError, FuseSession, fuse_available

__all__ = ["FuseSession", "FuseError", "fuse_available"]
