"""Snapshotter core (reference snapshot/ + pkg/label + pkg/snapshot)."""
