"""Device ops of the port: each kernel with its plain PyTorch version."""
