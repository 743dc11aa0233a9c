"""Process-wide support of the PyTorch port: the metrics group and the
span recorder that the checkpoint manager reports through, the chunk
service's transport, and the world's membership generation."""
