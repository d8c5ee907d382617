"""Hand-written CUDA kernels of the port, each beside its plain version."""

# The plain versions use repro_torch.core.topk, and repro_torch.core's
# engine and sharded search import the kernels: loading core first keeps
# that cycle in one order whichever package is imported first.
import repro_torch.core  # noqa: F401
