"""Multi-device layouts of the PyTorch port: the logical sharding rules
onto a ``DeviceMesh`` and the elastic restore onto whatever world exists
now."""
