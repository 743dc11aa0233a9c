"""The plain reference: float32 PyTorch written from the published
architectures, with no kernel, cache or batching of the program.  It
imports nothing of the program and reads only what the benchmark made:
the weights, the tokens and the configuration file."""
