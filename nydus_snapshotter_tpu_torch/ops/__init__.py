"""Conversion data-plane ops: gear hash, CDC, SHA-256, dict probe, fused path, mesh packing."""
