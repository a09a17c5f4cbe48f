"""nydus_snapshotter_tpu_torch — the conversion data plane in PyTorch and CUDA.

The port of ``nydus_snapshotter_tpu`` to PyTorch on an NVIDIA H100. This
slice carries the fused convert path — gear candidate bitmaps, FastCDC cut
resolution, chunk SHA-256, the chunk-dict probe and RAFS blob + bootstrap
emission — with its three device kernels written by hand in CUDA C++ for
``sm_90a`` (``csrc/``), each held against a plain PyTorch version that lives
beside it.

Entry points run on the card unless the caller passes ``device="cpu"``;
without CUDA and without that request they raise.
"""
