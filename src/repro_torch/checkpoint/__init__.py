"""Checkpoint tensor layer of the PyTorch port: the content-addressed
chunk store, its manifest (the reference's v3 format, so a step directory
written by either package restores in the other), and the manager."""
