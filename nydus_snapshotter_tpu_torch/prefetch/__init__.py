from nydus_snapshotter_tpu_torch.prefetch.prefetch import Pm, PrefetchManager

__all__ = ["Pm", "PrefetchManager"]
