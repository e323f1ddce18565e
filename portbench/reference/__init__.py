"""Plain PyTorch reference of Whisper's published architecture and of the
decoding rules the benchmark judges the system by. Imports nothing of the
system under test and nothing of JAX."""
