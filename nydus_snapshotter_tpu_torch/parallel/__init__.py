"""The device mesh, the sharded chunk dict and its service, the pipeline, the multi-host rendezvous."""
