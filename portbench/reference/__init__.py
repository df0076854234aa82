"""The plain PyTorch reference the benchmark judges the port against:
``iwae`` (the model, its bound, gradients, Adam and the streamed
log-likelihood) and ``draws`` (the program's random draws, worked out again
from the seeds). It imports nothing of the port and nothing of JAX."""
