from nydus_snapshotter_tpu_torch.system.system import SystemController

__all__ = ["SystemController"]
