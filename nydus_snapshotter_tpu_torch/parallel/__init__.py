"""Chunk-dict state (single shard in this slice)."""
